"""Fused top-2 barcode matcher: a Pallas kernel on the Triton route (GPU).

The XLA path (:func:`fqtk_tpu.ops.matcher.make_assign_fn`) runs each
whitelist chunk as a GEMM that writes the ``[B, kc]`` count matrix to device
memory, then reads it back for two row minima.  This kernel keeps every
count in registers:

- the grid covers batch tiles only; each block loads its ``[TB, Q]`` packed
  observation rows (bit2: four 2-bit ACGT codes per byte; nib4: two 4-bit
  IUPAC masks per byte, low bits = lower position — the native engine's
  transfer layouts, also decoded by :mod:`.device_encoding`) and builds the
  one-hot ``[TB, WLP]`` (``W`` classes x ``L`` positions, class-major,
  padded to a power of two) in registers;
- a ``fori_loop`` walks the whitelist in ``TK``-column tiles of the
  class-major compat table (``num_stages`` pipelines the tile loads); each
  step is one int8 x int8 -> int32 dot, a combined key ``count * TK + col``,
  a row min and a masked row min, folded into a running ``(best, idx,
  next)`` — the ordered monoid of :func:`fqtk_tpu.ops.matcher.merge_top2`,
  so the first index wins ties exactly as in the reference scan
  (``barcode_matching.rs:132``);
- only three ``[B]`` int32 vectors leave the kernel.  No ``[B, K]`` matrix
  reaches device memory and no step reduces across blocks.

Precision: every operand of the dot is a small exact integer in int8 (the
one-hot carries ``key_s1``, the compat table ``key_s2``, both <= 64) and the
accumulation is int32, so ``dot == count * TK`` exactly (``count <= L <=
255``, ``key_s1 * key_s2 == TK <= 4096``: at most ``255 * 4096 < 2^31``).
No float ever enters the contraction.

The module is factored so the whitelist-sharded mesh path
(:mod:`fqtk_tpu.parallel.mesh`) runs the same kernel per shard inside
``shard_map``: :func:`plan_local_kernel` (static tiling for ``k`` local
columns), :func:`compat_for_plan` (the scaled, padded class-major table for
a mask slice) and :func:`make_kernel_runner` (``(obs_packed[B, Q],
compat) -> (best, idx, next)``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .matcher import MAX_COUNT, ExpectedSet


#: Triton launch shape: warps per block and software-pipeline stages of the
#: whitelist-tile loads (see plan_local_kernel for how they were chosen)
NUM_WARPS, NUM_STAGES = 4, 3


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclass(frozen=True)
class KernelPlan:
    """Static decisions for one kernel instantiation over ``k`` columns."""

    k: int
    length: int
    #: one-hot classes per position: 4 (bit2 codes) or 16 (nib4 masks)
    onehot_width: int
    #: one-hot width ``W * L`` padded to a power of two (>= 32: int8 MMA depth)
    wl_padded: int
    #: bytes per packed observation row
    packed_width: int
    tile_b: int
    tile_k: int
    n_k_tiles: int
    k_padded: int
    key_s1: int
    key_s2: int
    interpret: bool

    @property
    def packed2(self) -> bool:
        return self.onehot_width == 4


def plan_local_kernel(
    k: int,
    length: int,
    packed2: bool,
    tile_b: int = 256,
    tile_k: int = 64,
    interpret: bool = False,
) -> KernelPlan:
    """Choose tiling for ``k`` local whitelist columns of ``length`` bp.

    The defaults (256-row blocks, 64-column tiles, 4 warps, 3 stages) were
    the fastest of a sweep over block, tile, warp and stage counts on an
    H100 at K=8,192 and K=737,280 (PERF.md): the per-tile epilogue, not the
    dot, sets the time, and narrow tiles keep it in registers."""
    if length > 255:
        raise ValueError(
            "the fused matcher supports barcode lengths <= 255 (combined-key "
            "exactness bound); use the XLA scan for longer barcodes"
        )
    for name, v in (("tile_b", tile_b), ("tile_k", tile_k)):
        if v < 16 or v & (v - 1):
            raise ValueError(f"{name} must be a power of two >= 16, got {v}")
    onehot_width = 4 if packed2 else 16
    # Triton blocks are powers of two; a K tile never exceeds the (padded)
    # whitelist, and key_s1 * key_s2 == tile_k must split into int8 factors
    tile_k = min(tile_k, max(32, _next_pow2(k)), 4096)
    n_k_tiles = -(-k // tile_k)
    log_tk = tile_k.bit_length() - 1
    key_s1 = 1 << ((log_tk + 1) // 2)
    return KernelPlan(
        k=k,
        length=length,
        onehot_width=onehot_width,
        wl_padded=max(32, _next_pow2(onehot_width * length)),
        packed_width=-(-length // (4 if packed2 else 2)),
        tile_b=tile_b,
        tile_k=tile_k,
        n_k_tiles=n_k_tiles,
        k_padded=n_k_tiles * tile_k,
        key_s1=key_s1,
        key_s2=tile_k // key_s1,
        interpret=interpret,
    )


def compat_for_plan(masks: np.ndarray, plan: KernelPlan) -> np.ndarray:
    """Scaled class-major mismatch table ``[WLP, k_padded] int8``.

    Row ``c * L + l`` holds ``key_s2`` where class ``c`` (code ``c``'s mask
    for bit2, mask value ``c`` for nib4) has a bit outside expected base
    ``(k, l)``, else 0.  Pad columns mismatch at every position (count
    exactly ``L``: the highest count a real column can reach, at higher
    indices, so the first-index tie-break keeps them from winning while a
    real column exists).  Pad rows are zero.  ``masks`` is ``[k, L] uint8``
    (``ExpectedSet.masks`` or a whitelist-shard slice of it)."""
    k, length = masks.shape
    w = plan.onehot_width
    c = (
        np.array([1, 2, 4, 8], dtype=np.uint8)
        if w == 4
        else np.arange(16, dtype=np.uint8)
    )
    viol = (c[:, None, None] & ~masks.T[None, :, :]) & 0xF  # [W, L, k]
    table = np.zeros((plan.wl_padded, plan.k_padded), dtype=np.int8)
    table[: w * length, :k] = (viol != 0).reshape(w * length, k)
    table[: w * length, k:] = 1
    return table * np.int8(plan.key_s2)


def make_kernel_runner(plan: KernelPlan):
    """Build ``run(obs_packed[B, Q] uint8, compat) -> (best, idx, next)``.

    ``B`` must be a multiple of ``plan.tile_b``; ``compat`` is
    :func:`compat_for_plan`'s table on device.  A pure function of the local
    columns: used directly by the single-device path and per shard under
    ``shard_map`` by the whitelist-sharded mesh path."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    tile_b, tile_k = plan.tile_b, plan.tile_k
    length, wlp = plan.length, plan.wl_padded
    n_k_tiles, key_s1 = plan.n_k_tiles, plan.key_s1
    bits = 2 if plan.packed2 else 4
    per_byte = 8 // bits
    log_tk = tile_k.bit_length() - 1
    big = (MAX_COUNT + 1) * tile_k  # above every key in a tile

    # one-hot column j <-> (position j % L, class j // L); pad columns get a
    # position no read has and a class no value equals
    j = np.arange(wlp)
    col_pos = np.where(j < plan.onehot_width * length, j % length, -1)
    col_cls = np.where(j < plan.onehot_width * length, j // length, -2)

    def kernel(obs_ref, pos_ref, cls_ref, compat_ref, best_ref, idx_ref, nxt_ref):
        pos = pos_ref[:][None, :]
        cls = cls_ref[:][None, :]
        sel = jnp.full((tile_b, wlp), -1, jnp.int32)
        for q in range(plan.packed_width):
            byte = obs_ref[:, q].astype(jnp.int32)  # [TB]
            for s in range(per_byte):
                l = q * per_byte + s
                if l < length:
                    val = (byte >> (bits * s)) & ((1 << bits) - 1)
                    sel = jnp.where(pos == l, val[:, None], sel)
        onehot = jnp.where(sel == cls, key_s1, 0).astype(jnp.int8)
        lcol = jax.lax.broadcasted_iota(jnp.int32, (tile_b, tile_k), 1)

        def step(t, carry):
            a_best, a_idx, a_next = carry
            k0 = pl.multiple_of(t * tile_k, tile_k)
            tile = compat_ref[:, pl.ds(k0, tile_k)]  # [WLP, TK] int8
            # int8 x int8 -> int32: count * TK, exact (module docstring)
            key = jnp.dot(onehot, tile, preferred_element_type=jnp.int32) + lcol
            m1 = jnp.min(key, axis=1)
            m2 = jnp.min(jnp.where(key == m1[:, None], big, key), axis=1)
            t_best = m1 >> log_tk
            t_idx = (m1 & (tile_k - 1)) + k0
            t_next = m2 >> log_tk
            take = t_best < a_best  # strict: the earlier tile wins ties
            return (
                jnp.where(take, t_best, a_best),
                jnp.where(take, t_idx, a_idx),
                jnp.where(
                    take,
                    jnp.minimum(a_best, t_next),
                    jnp.minimum(a_next, t_best),
                ),
            )

        init = (
            jnp.full((tile_b,), MAX_COUNT, jnp.int32),
            jnp.full((tile_b,), plan.k, jnp.int32),
            jnp.full((tile_b,), MAX_COUNT, jnp.int32),
        )
        best, idx, nxt = jax.lax.fori_loop(0, n_k_tiles, step, init)
        best_ref[:] = best
        idx_ref[:] = idx
        nxt_ref[:] = nxt

    def run(obs_packed, compat):
        b = obs_packed.shape[0]
        vec = jax.ShapeDtypeStruct((b,), jnp.int32)
        vec_spec = pl.BlockSpec((tile_b,), lambda i: (i,))
        return pl.pallas_call(
            kernel,
            grid=(b // tile_b,),
            in_specs=[
                pl.BlockSpec((tile_b, plan.packed_width), lambda i: (i, 0)),
                pl.BlockSpec((wlp,), lambda i: (0,)),
                pl.BlockSpec((wlp,), lambda i: (0,)),
                pl.BlockSpec((wlp, plan.k_padded), lambda i: (0, 0)),
            ],
            out_specs=[vec_spec, vec_spec, vec_spec],
            out_shape=[vec, vec, vec],
            compiler_params=plgpu.CompilerParams(
                num_warps=NUM_WARPS, num_stages=NUM_STAGES
            ),
            interpret=plan.interpret,
            name="fused_top2_matcher",
        )(
            obs_packed.astype(jnp.uint8),
            jnp.asarray(col_pos, jnp.int32),
            jnp.asarray(col_cls, jnp.int32),
            compat,
        )

    return run


def make_pallas_assign_fn(
    expected: ExpectedSet,
    max_mismatches: int,
    min_mismatch_delta: int,
    packed2: bool = True,
    compact_output: bool = False,
    tile_b: int = 256,
    tile_k: int = 64,
    interpret: bool = False,
):
    """Build ``obs_packed[B, Q] -> (assigned, best, next)`` on the kernel.

    ``packed2``: input is ``[B, ceil(L/4)] uint8`` bit2 codes (pure-ACGT
    rows; the engine resolves ambiguous rows and their no-call gate on the
    host).  Otherwise ``[B, ceil(L/2)] uint8`` nib4 masks, with the no-call
    gate applied here (``mask == 15`` is exactly a no-call).
    ``assigned == expected.count`` means unmatched; ``compact_output``
    returns it as uint8 when ``K < 255``.  Any ``B`` works: the batch is
    padded to a ``tile_b`` multiple and sliced back.  ``interpret=True``
    runs the kernel in the Pallas interpreter (tests on the CPU)."""
    import jax
    import jax.numpy as jnp

    from .device_encoding import unpack_nib4

    k, length = expected.count, expected.length
    plan = plan_local_kernel(
        k, length, packed2, tile_b=tile_b, tile_k=tile_k, interpret=interpret,
    )
    run_kernel = make_kernel_runner(plan)
    # the whitelist rides as an argument: baked in as a constant it would
    # bloat the executable (tens of MB at a 737K whitelist)
    compat_dev = jax.device_put(compat_for_plan(expected.masks, plan))
    nocall_budget = max_mismatches + expected.max_ns_in_barcodes
    out_dtype = jnp.uint8 if (compact_output and k < 255) else jnp.int32

    @jax.jit
    def _assign(obs_in, compat):
        best, bidx, nxt = run_kernel(obs_in, compat)
        if k == 1:
            # no real runner-up: pad columns report L, the spec says MAX_COUNT
            nxt = jnp.full_like(nxt, MAX_COUNT)
        ok = (best <= max_mismatches) & (nxt - best >= min_mismatch_delta)
        if not packed2:
            masks = unpack_nib4(obs_in.astype(jnp.uint8), length)
            ok &= jnp.sum((masks == 15).astype(jnp.int32), axis=1) <= nocall_budget
        return jnp.where(ok, bidx, k).astype(out_dtype), best, nxt

    # all-'A' pad rows: code 0 (bit2) / mask 1 in both nibbles (nib4)
    pad_byte = 0x00 if packed2 else 0x11

    def assign(obs_packed):
        obs = np.asarray(obs_packed)
        b = obs.shape[0]
        pad = (-b) % tile_b
        if pad:
            obs = np.pad(obs, ((0, pad), (0, 0)), constant_values=pad_byte)
        idx, best, nxt = _assign(obs, compat_dev)
        if pad:
            idx, best, nxt = idx[:b], best[:b], nxt[:b]
        return idx, best, nxt

    assign.plan = plan
    return assign
