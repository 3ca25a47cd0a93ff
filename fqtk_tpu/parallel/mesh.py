"""Multi-device demux: data-parallel reads x K-sharded whitelists.

The reference is single-process multi-threaded (SURVEY.md §2c); its only
parallelism is a 3-stage host pipeline.  The device scale-out replaces it
with a 2-D device mesh:

- ``batch`` axis: FASTQ record batches stream data-parallel — each device
  matches its shard of reads.  Host-side sharding; no collectives needed for
  assignment itself.
- ``whitelist`` axis: the expected-barcode table is sharded over K for huge
  whitelists (e.g. 737K single-cell barcodes).  Each shard computes a local
  (best, idx, next) triple; shards merge with an ``all_gather`` over the
  whitelist axis followed by an ordered fold of the same associative monoid
  used for K-chunking (:func:`fqtk_tpu.ops.matcher.merge_top2`) — ascending
  shard order preserves the reference's first-index tie-break.

The per-device (per-shard) top-2 runs the same fused Triton kernel as the
single-device path (``ops/pallas_matcher.py``) when the caller asks for it
(``use_kernel``; the demux driver does on a GPU backend), with compat shards
built per device slice so the full table never materializes host-side.
Otherwise it runs the chunked XLA contraction, which lowers everywhere; both
share the cross-shard merge and gates, and both are validated against the
NumPy spec.  Every device reaches every other at the same rate (NVLink, all
to all), so the mesh shape follows the algorithm alone.

Per-sample template counts are computed on device (one-hot sum) and reduced
with ``psum`` over the batch axis, reproducing the reference's single global
``DemuxMetric`` counts (associative integer sums, SURVEY.md §5).

Multi-host: the same program runs under ``jax.distributed`` with each host
feeding its input shard; counts ride the same ``psum``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.matcher import MAX_COUNT, ExpectedSet, merge_top2


def make_demux_mesh(
    n_batch: Optional[int] = None, n_whitelist: int = 1, devices=None
):
    """Create a ``(batch, whitelist)`` mesh over the available devices."""
    import jax

    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_batch is None:
        assert n % n_whitelist == 0, (n, n_whitelist)
        n_batch = n // n_whitelist
    assert n_batch * n_whitelist <= n
    dev_array = np.asarray(devices[: n_batch * n_whitelist]).reshape(
        n_batch, n_whitelist
    )
    return jax.sharding.Mesh(dev_array, ("batch", "whitelist"))


def _compat_positionmajor(
    masks: np.ndarray, k_padded: int, onehot_width: int
) -> np.ndarray:
    """Mismatch-indicator table in *position-major* row layout ``l*W + c``
    (the XLA contraction's one-hot order; class-major is the Pallas
    kernel's).  ``masks`` is ``[K, L] uint8``; pad columns are all-ones."""
    k, length = masks.shape
    if onehot_width == 4:
        c = np.array([1, 2, 4, 8], dtype=np.uint8)
    else:
        c = np.arange(16, dtype=np.uint8)
    viol = (c[None, None, :] & ~masks.T[:, :, None]) & 0xF  # [L, K, W]
    compat = np.ascontiguousarray(
        (viol != 0)
        .astype(np.int8)
        .transpose(0, 2, 1)
        .reshape(length * onehot_width, k)
    )
    if k_padded != k:
        pad = np.ones((compat.shape[0], k_padded - k), dtype=np.int8)
        compat = np.concatenate([compat, pad], axis=1)
    return compat


def make_sharded_assign_fn(
    expected: ExpectedSet,
    max_mismatches: int,
    min_mismatch_delta: int,
    mesh,
    k_chunk: int = 16384,
    packed_masks: bool = False,
    packed2: bool = False,
    compact_output: bool = False,
    with_counts: bool = True,
    use_kernel: bool = False,
    interpret: bool = False,
):
    """Build the sharded demux step: ``obs[B, L] -> (assigned[B], counts[K+1])``.

    - ``obs`` is sharded over the ``batch`` mesh axis.
    - the compat table is sharded over the ``whitelist`` axis (replicated when
      that axis has size 1), built shard-by-shard from ``expected.masks`` so
      the full table is never materialized host-side.
    - ``assigned`` comes back sharded over ``batch``; ``counts`` (per-sample
      template totals, with unmatched in slot K) is fully reduced
      (psum over both axes) and replicated.

    ``packed_masks``: input is ``[B, ceil(L/2)] uint8`` (two 4-bit IUPAC
    masks per byte, low nibble first — the native engine's layout).
    ``packed2``: input is ``[B, ceil(L/4)] uint8`` (four 2-bit ACGT codes
    per byte) — quarter-width transfers; ambiguous rows are resolved
    host-side by the engine, so the no-call gate is skipped.
    ``compact_output``: uint8 ``assigned`` when ``K < 255``.
    ``with_counts=False`` returns only ``assigned`` (the product pipeline
    counts host-side where skip/length flags are applied).
    ``use_kernel``: run the fused Triton top-2 kernel per shard (packed
    input only; compiles for a GPU backend) instead of the chunked XLA
    contraction; ``interpret=True`` runs it in the Pallas interpreter
    (tests on the CPU).

    The returned callable accepts ANY leading dim: it pads the batch to the
    mesh/tile multiple with 'A' rows and slices the pads back off (count
    contributions of pad rows are subtracted exactly).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    if packed_masks and packed2:
        raise ValueError("packed_masks and packed2 are mutually exclusive")
    if use_kernel and not (packed_masks or packed2):
        raise ValueError("the fused kernel takes packed (bit2/nib4) input")
    k = expected.count
    length = expected.length
    n_k_shards = mesh.shape["whitelist"]
    n_batch = mesh.shape["batch"]
    nocall_budget = max_mismatches + expected.max_ns_in_barcodes
    onehot_width = 4 if packed2 else 16

    # contiguous K shards of ceil(K / n_shards) columns; trailing shards may
    # carry all-ones padding columns (and may even be all-padding for tiny
    # K), which is safe: pad columns score exactly L, real columns occupy
    # the lower in-shard positions, and the first-index tie-break (within a
    # shard AND across the ordered merge) means a pad can only surface when
    # no real column exists anywhere — impossible with K >= 1.
    k_per_shard = -(-k // n_k_shards)

    from ..ops.device_encoding import (
        byte_is_nocall,
        byte_to_mask,
        unpack_bit2,
        unpack_nib4,
    )

    def _obs_vals(obs_in):
        """[B, L] class values: IUPAC masks (nib4/raw) or 2-bit codes."""
        if packed2:
            return unpack_bit2(obs_in, length)
        if packed_masks:
            return unpack_nib4(obs_in, length)
        return byte_to_mask(obs_in)

    if use_kernel:
        from ..ops.pallas_matcher import (
            compat_for_plan,
            make_kernel_runner,
            plan_local_kernel,
        )

        # one plan for every shard (shard_map runs a single program)
        plan = plan_local_kernel(
            k_per_shard, length, packed2, interpret=interpret
        )
        run_kernel = make_kernel_runner(plan)
        in_dtype = jnp.int8
        # per-shard compat slices: peak host memory is one shard's table
        # (~K/n of the full one), not the eager [L*W, K] monolith
        shard_tables = []
        for s in range(n_k_shards):
            masks_s = expected.masks[s * k_per_shard:(s + 1) * k_per_shard]
            shard_tables.append(compat_for_plan(masks_s, plan))
        compat_host = np.concatenate(shard_tables, axis=1)
        del shard_tables
        batch_multiple = n_batch * plan.tile_b

        def local_top2(obs_bytes, compat_local):
            best, bidx, nxt = run_kernel(obs_bytes, compat_local)
            shard_off = jax.lax.axis_index("whitelist") * k_per_shard
            return best, bidx + shard_off, nxt

    else:
        in_dtype = jnp.int8
        shard_tables = []
        for s in range(n_k_shards):
            masks_s = expected.masks[s * k_per_shard:(s + 1) * k_per_shard]
            shard_tables.append(
                _compat_positionmajor(masks_s, k_per_shard, onehot_width)
            )
        compat_host = np.concatenate(shard_tables, axis=1)
        del shard_tables
        batch_multiple = n_batch

        def local_top2(obs_bytes, compat_local):
            """Per-device top-2 over the local K shard (chunked like the
            single-device path so [b_local, K_local] never materializes
            whole)."""
            b = obs_bytes.shape[0]
            vals = _obs_vals(obs_bytes)
            onehot = (
                vals[:, :, None]
                == jnp.arange(onehot_width, dtype=jnp.int32)[None, None, :]
            ).astype(jnp.int8)
            obs16 = onehot.reshape(b, length * onehot_width)

            kc = min(k_chunk, k_per_shard)
            n_chunks = -(-k_per_shard // kc)
            kc_padded = n_chunks * kc
            if kc_padded != k_per_shard:
                compat_local = jnp.concatenate(
                    [
                        compat_local,
                        jnp.ones(
                            (length * onehot_width, kc_padded - k_per_shard),
                            dtype=jnp.int8,
                        ),
                    ],
                    axis=1,
                )
            cc = compat_local.reshape(
                length * onehot_width, n_chunks, kc
            ).transpose(1, 0, 2)

            shard_idx = jax.lax.axis_index("whitelist")
            shard_off = shard_idx * k_per_shard

            def body(carry, xs):
                chunk_i, chunk_compat = xs
                # int8 0/1 operands, int32 accumulation: exact counts
                counts = jax.lax.dot_general(
                    obs16,
                    chunk_compat,
                    dimension_numbers=(((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32,
                )
                counts = jnp.minimum(counts, MAX_COUNT)
                col = jnp.arange(kc, dtype=jnp.int32) + chunk_i * kc
                # global column index; mask shard padding AND global padding
                counts = jnp.where(col[None, :] < k_per_shard, counts, MAX_COUNT)
                gcol = col + shard_off
                counts = jnp.where(gcol[None, :] < k, counts, MAX_COUNT)
                cb = jnp.min(counts, axis=-1)
                ci = jnp.argmin(counts, axis=-1).astype(jnp.int32) + chunk_i * kc
                colm = jnp.arange(kc, dtype=jnp.int32)
                masked = jnp.where(
                    colm[None, :] == (ci - chunk_i * kc)[:, None], MAX_COUNT, counts
                )
                cn = (
                    jnp.min(masked, axis=-1)
                    if kc > 1
                    else jnp.full_like(cb, MAX_COUNT)
                )
                return merge_top2(carry, (cb, ci, cn)), None

            init = (
                jnp.full((b,), MAX_COUNT, dtype=jnp.int32),
                jnp.full((b,), k_per_shard, dtype=jnp.int32),
                jnp.full((b,), MAX_COUNT, dtype=jnp.int32),
            )
            if n_chunks == 1:
                (best, bidx, nxt), _ = body(init, (jnp.int32(0), cc[0]))
            else:
                (best, bidx, nxt), _ = jax.lax.scan(
                    body, init, (jnp.arange(n_chunks, dtype=jnp.int32), cc)
                )
            return best, bidx + shard_off, nxt

    def step(obs_bytes, compat_sharded):
        # local phase: each (batch, whitelist) tile computes its local top-2
        best, bidx, nxt = local_top2(obs_bytes, compat_sharded)

        # merge across whitelist shards in ascending shard order (preserves
        # first-index tie-break of the reference scan)
        if n_k_shards > 1:
            g = jax.lax.all_gather((best, bidx, nxt), "whitelist")  # [nk, b]
            acc = (g[0][0], g[1][0], g[2][0])
            for s in range(1, n_k_shards):
                acc = merge_top2(acc, (g[0][s], g[1][s], g[2][s]))
            best, bidx, nxt = acc

        if k == 1:
            # no real runner-up exists: the spec says MAX_COUNT (u8 init of
            # the reference).  The kernel's shard path reports L from its
            # unmasked pad columns; the XLA path masks them — normalize both.
            nxt = jnp.full_like(nxt, MAX_COUNT)

        if packed2:
            # pure-ACGT rows by construction; ambiguous rows (including the
            # no-call gate) resolve host-side in the engine
            ok = (best <= max_mismatches) & (nxt - best >= min_mismatch_delta)
        else:
            if packed_masks:
                nocalls = jnp.sum(
                    (_obs_vals(obs_bytes) == 15).astype(jnp.int32), axis=1
                )
            else:
                nocalls = jnp.sum(byte_is_nocall(obs_bytes), axis=1)
            ok = (
                (nocalls <= nocall_budget)
                & (best <= max_mismatches)
                & (nxt - best >= min_mismatch_delta)
            )
        out_dtype = jnp.uint8 if (compact_output and k < 255) else jnp.int32
        assigned = jnp.where(ok, bidx, k).astype(out_dtype)

        if not with_counts:
            return assigned

        # per-sample counts: one-hot sum over the local batch, then psum over
        # the batch axis (whitelist axis already sees identical values)
        onehot_counts = jnp.sum(
            (
                assigned.astype(jnp.int32)[:, None]
                == jnp.arange(k + 1, dtype=jnp.int32)[None, :]
            ).astype(jnp.int32),
            axis=0,
        )
        counts = jax.lax.psum(onehot_counts, "batch")
        return assigned, counts

    P_obs = P("batch", None)
    P_compat = P(None, "whitelist")
    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P_obs, P_compat),
        out_specs=(P("batch"), P(None)) if with_counts else P("batch"),
        check_vma=False,
    )
    jitted = jax.jit(sharded)

    compat_dev = jax.device_put(
        compat_host.astype(in_dtype), NamedSharding(mesh, P_compat)
    )
    obs_sharding = NamedSharding(mesh, P_obs)

    if packed2:
        pad_byte = 0x00  # four 'A' codes
    elif packed_masks:
        pad_byte = 0x11  # 'AA' nib4
    else:
        pad_byte = ord("A")

    def assign(obs_bytes):
        obs = np.asarray(obs_bytes)
        b = obs.shape[0]
        pad = (-b) % batch_multiple
        if pad:
            obs = np.ascontiguousarray(
                np.pad(obs, ((0, pad), (0, 0)), constant_values=pad_byte)
            )
        # placed straight onto the batch shards (never staged whole on one
        # device before the jit reshards it)
        obs_dev = jax.device_put(obs.astype(np.uint8, copy=False), obs_sharding)
        out = jitted(obs_dev, compat_dev)
        if not with_counts:
            return out[:b] if pad else out
        assigned, counts = out
        if pad:
            # pad rows are all-'A' observations that may legitimately match
            # a sample; remove their count contributions exactly
            extra = np.asarray(assigned[b:]).astype(np.int64)
            counts = counts - jnp.asarray(
                np.bincount(extra, minlength=k + 1), dtype=counts.dtype
            )
            assigned = assigned[:b]
        return assigned, counts

    assign.mesh = mesh
    assign.n_k_shards = n_k_shards
    assign.use_kernel = use_kernel
    assign.batch_multiple = batch_multiple
    return assign
