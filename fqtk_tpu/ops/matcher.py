"""Batched barcode matching: the device-side core of demultiplexing.

Reference semantics being reproduced (``/root/reference/src/lib/barcode_matching.rs``
and ``src/lib/bitenc.rs:432-459``):

- mismatch(obs_base, exp_base) = 1 iff ``obs_mask & ~exp_mask != 0``
  (asymmetric IUPAC containment; expected ``N`` matches everything, observed
  ``N`` only matches expected bases whose mask contains all 4 bits).
- per-read result = index of the sample with the fewest mismatches; a read is
  assigned iff ``best <= max_mismatches`` and
  ``next_best - best >= min_mismatch_delta`` (``barcode_matching.rs:149-159``)
  where ``next_best`` is 255 when there is a single sample (u8 init value).
- prefilter: reads whose no-call count exceeds
  ``max_mismatches + max_ns_in_barcodes`` are unassigned
  (``barcode_matching.rs:170-172``).
- mismatch counts saturate at 255 (u8 semantics of the reference).

Device mapping: rather than the reference's scalar ``u32``-block popcount
loop with memoization, we batch ``B`` reads and compute ALL pairwise
mismatch counts with one matrix multiplication of 0/1 operands:

- observed bytes -> 4-bit masks via a 256-entry LUT -> one-hot over the 16
  possible mask values: ``obs16[B, L*16]``.
- expected side: ``compat[L*16, K]`` with ``compat[l*16+c, k] = 1`` iff mask
  value ``c`` mismatches expected base ``(k, l)``.
- ``counts[B, K] = obs16 @ compat`` — an exact mismatch count, since each
  (read, position) contributes exactly one nonzero column (bf16 operands
  with f32 accumulation here; int8 with int32 in the fused kernel,
  :mod:`fqtk_tpu.ops.pallas_matcher`).

The per-read memo cache of the reference is subsumed by batching.  Top-2 with
first-index tie-breaking is computed by scanning K in chunks with an
associative (best, idx, next) merge, which also serves as the cross-device
monoid when the whitelist is sharded over K (see ``fqtk_tpu.parallel``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from ..core.encoding import ENCODE_LUT, NOCALL_LUT, count_nocalls

UNMATCHED = -1  # sentinel in *logical* output; device uses index K
MAX_COUNT = 255  # u8 saturation of the reference


@dataclass(frozen=True)
class ExpectedSet:
    """Pre-encoded expected-barcode whitelist (device-ready constants)."""

    masks: np.ndarray  # [K, L] uint8 4-bit masks of uppercased barcodes
    max_ns_in_barcodes: int
    length: int
    count: int

    @classmethod
    def from_barcodes(cls, barcodes: Sequence[str]) -> "ExpectedSet":
        if not barcodes:
            raise ValueError("Must provide at least one sample")
        if any(len(b) == 0 for b in barcodes):
            raise ValueError("Sample barcode cannot be empty string")
        upper = [b.upper().encode("ascii") for b in barcodes]
        length = len(upper[0])
        if any(len(b) != length for b in upper):
            raise ValueError("All barcodes must have the same length")
        max_ns = max(count_nocalls(b) for b in upper)
        arr = np.frombuffer(b"".join(upper), dtype=np.uint8).reshape(len(upper), length)
        masks = ENCODE_LUT[arr]  # [K, L]
        return cls(
            masks=masks,
            max_ns_in_barcodes=max_ns,
            length=length,
            count=len(upper),
        )

    @property
    def compat(self) -> np.ndarray:
        """[L*16, K] int8 mismatch-indicator table, built on first use.

        Lazy because only the XLA nib4/raw contraction reads it: at the
        737K-barcode single-cell scale it is ~189 MB (plus a same-sized
        transient), pure waste for the pigeonhole/small-K host matchers,
        the packed2 path (compat4), and the Pallas kernel (class-major)."""
        cached = getattr(self, "_compat", None)
        if cached is None:
            # compat[l, c, k] = 1 iff mask value c has a bit outside
            # masks[k, l]
            c = np.arange(16, dtype=np.uint8)  # all observed mask values
            viol = (c[None, None, :] & ~self.masks.T[:, :, None]) & 0xF
            cached = np.ascontiguousarray(
                (viol != 0)
                .astype(np.int8)
                .transpose(0, 2, 1)
                .reshape(self.length * 16, self.count)
            )
            object.__setattr__(self, "_compat", cached)
        return cached


def mismatch_counts_np(obs_bytes: np.ndarray, expected: ExpectedSet) -> np.ndarray:
    """NumPy executable spec: exact mismatch counts [B, K], saturated at 255."""
    obs_masks = ENCODE_LUT[np.asarray(obs_bytes, dtype=np.uint8)]  # [B, L]
    # obs & ~exp per (b, k, l) without one-hot (fine at test scale)
    diff = (obs_masks[:, None, :] & ~expected.masks[None, :, :]) & 0xF
    counts = (diff != 0).sum(axis=2)
    return np.minimum(counts, MAX_COUNT).astype(np.int32)


def assign_batch_np(
    obs_bytes: np.ndarray,
    expected: ExpectedSet,
    max_mismatches: int,
    min_mismatch_delta: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """NumPy spec of the full assignment: (assigned_idx, best_mm, next_mm).

    ``assigned_idx`` is ``UNMATCHED`` (-1) for unassigned reads.
    """
    obs_bytes = np.asarray(obs_bytes, dtype=np.uint8)
    obs_masks = ENCODE_LUT[obs_bytes]
    nocalls = NOCALL_LUT[obs_bytes].sum(axis=1)
    return assign_batch_np_masks(
        obs_masks, expected, max_mismatches, min_mismatch_delta, nocalls=nocalls
    )


def assign_batch_np_masks(
    obs_masks: np.ndarray,
    expected: ExpectedSet,
    max_mismatches: int,
    min_mismatch_delta: int,
    nocalls: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``assign_batch_np`` over pre-encoded 4-bit IUPAC masks ``[B, L]``
    (the native engine's nib4 transfer payload).  ``mask == 15`` is exactly
    the no-call indicator (N/n/. and nothing else encode to 15), so the
    no-call prefilter needs no byte-level view."""
    obs_masks = np.asarray(obs_masks)
    diff = (obs_masks[:, None, :] & ~expected.masks[None, :, :]) & 0xF
    counts = np.minimum((diff != 0).sum(axis=2), MAX_COUNT).astype(np.int32)
    b = counts.shape[0]
    best_idx = counts.argmin(axis=1).astype(np.int32)
    best = counts[np.arange(b), best_idx]
    masked = counts.copy()
    masked[np.arange(b), best_idx] = MAX_COUNT
    if expected.count == 1:
        next_best = np.full(b, MAX_COUNT, dtype=np.int32)
    else:
        next_best = np.minimum(masked.min(axis=1), MAX_COUNT)
    if nocalls is None:
        nocalls = (obs_masks == 15).sum(axis=1)
    ok = (
        (nocalls <= max_mismatches + expected.max_ns_in_barcodes)
        & (best <= max_mismatches)
        & (next_best - best >= min_mismatch_delta)
    )
    assigned = np.where(ok, best_idx, UNMATCHED).astype(np.int32)
    return assigned, best.astype(np.int32), next_best.astype(np.int32)


# ----------------------------------------------------------------------------
# JAX / XLA path
# ----------------------------------------------------------------------------


def merge_top2(a, b):
    """Associative merge of (best, idx, next) triples.

    All indices in ``a`` must precede all indices in ``b`` (first-index
    tie-break: on equal best counts the earlier candidate wins, matching the
    reference's strict ``<`` update at ``barcode_matching.rs:132``).
    Also the cross-shard monoid for K-sharded whitelists.
    """
    import jax.numpy as jnp

    a_best, a_idx, a_next = a
    b_best, b_idx, b_next = b
    take_b = b_best < a_best
    best = jnp.where(take_b, b_best, a_best)
    idx = jnp.where(take_b, b_idx, a_idx)
    nxt = jnp.where(take_b, jnp.minimum(a_best, b_next), jnp.minimum(a_next, b_best))
    return best, idx, nxt


def make_assign_fn(
    expected: ExpectedSet,
    max_mismatches: int,
    min_mismatch_delta: int,
    k_chunk: int = 16384,
    packed_masks: bool = False,
    packed2: bool = False,
    compact_output: bool = False,
):
    """Build a jitted ``obs[B, L] -> (assigned, best, next)`` function.

    ``assigned[b] == expected.count`` denotes unmatched (dense sentinel so the
    result can index a ``K+1``-row routing table on device).

    K is processed in chunks of ``k_chunk`` via ``lax.scan`` so the full
    [B, K] mismatch matrix never exists at once — required for huge
    single-cell whitelists (737K barcodes).  The chunk is bounded twice:
    the f32 combined key below is exact only for ``k_chunk <= 2^15``, and
    each chunk's ``[B, k_chunk]`` f32 counts are materialized in device
    memory (8 GiB at the production batch of 2^17 rows and 16384 columns).

    ``packed_masks``: input is ``[B, ceil(L/2)] uint8`` with two 4-bit IUPAC
    masks per byte (low nibble = even position) instead of raw ASCII — halves
    host->device transfer, and the no-call gate becomes ``mask == 15`` (only
    N/n/. encode to 15).  The native engine emits this layout.

    ``packed2``: input is ``[B, ceil(L/4)] uint8`` with four 2-bit ACGT
    codes per byte (low pair = lowest position) — QUARTER-width transfers
    and a 4x narrower one-hot contraction.  Only pure-ACGT/U reads can be
    encoded; the native engine flags ambiguous rows as exceptional and the
    driver resolves them host-side (including the no-call gate, so this
    path skips it entirely).

    ``compact_output``: return ``assigned`` as uint8 when ``K < 255`` (4x
    less device->host traffic).
    """
    import jax
    import jax.numpy as jnp

    if packed_masks and packed2:
        raise ValueError("packed_masks and packed2 are mutually exclusive")
    if not 1 <= k_chunk <= 1 << 15:
        raise ValueError(f"k_chunk must be in [1, 2^15], got {k_chunk}")
    k = expected.count
    length = expected.length
    kc = min(k_chunk, k)
    n_chunks = -(-k // kc)
    k_pad = n_chunks * kc
    if packed2:
        # compat4[l*4 + c, k] = 1 iff 2-bit code c mismatches barcode k at l
        code_masks = np.array([1, 2, 4, 8], dtype=np.uint8)
        viol4 = (code_masks[None, None, :] & ~expected.masks.T[:, :, None]) & 0xF
        compat = np.ascontiguousarray(
            (viol4 != 0).astype(np.int8).transpose(0, 2, 1).reshape(length * 4, k)
        )
    else:
        compat = expected.compat
    onehot_width = 4 if packed2 else 16
    if k_pad != k:
        # padding columns are masked to MAX_COUNT in the scan body
        pad = np.ones((compat.shape[0], k_pad - k), dtype=np.int8)
        compat = np.concatenate([compat, pad], axis=1)
    # [n_chunks, L*W, kc] so scan slices are contiguous (W = one-hot width)
    compat_chunks = np.ascontiguousarray(
        compat.reshape(length * onehot_width, n_chunks, kc).transpose(1, 0, 2)
    )
    nocall_budget = max_mismatches + expected.max_ns_in_barcodes

    from .device_encoding import (
        byte_is_nocall,
        byte_to_mask,
        unpack_bit2,
        unpack_nib4,
    )

    # Device-resident whitelist passed as an argument (constants this large
    # bloat the compiled program).  bf16 operands with f32 accumulation:
    # every operand is 0 or 1 and every count <= L, all exact — never f32
    # operands, which a GPU may multiply in TF32.
    compat_chunks_dev = jax.device_put(compat_chunks.astype(jnp.bfloat16))

    @jax.jit
    def _assign(obs_in, cc):
        obs_in = obs_in.astype(jnp.uint8)
        b = obs_in.shape[0]
        if packed2:
            obs_vals = unpack_bit2(obs_in, length)
            obs_masks = None
        else:
            if packed_masks:
                obs_masks = unpack_nib4(obs_in, length)
            else:
                obs_masks = byte_to_mask(obs_in)  # [B, L] int32 (no gathers)
            obs_vals = obs_masks
        classes = jnp.arange(onehot_width, dtype=jnp.int32)
        obs1h = (obs_vals[:, :, None] == classes[None, None, :]).astype(
            jnp.bfloat16
        ).reshape(b, length * onehot_width)

        # f32 combined-key reduction: key = count * kc + col encodes
        # (count, first-index) so ONE min yields both (exact: counts are
        # clamped to 255 and kc <= 2^15, so keys < 2^24).
        kcf = float(kc)
        col = jnp.arange(kc, dtype=jnp.float32)

        def scan_body(carry, xs):
            chunk_i, chunk_compat = xs
            counts = jax.lax.dot_general(
                obs1h,
                chunk_compat,
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )  # exact integers <= L
            gcol = jnp.arange(kc, dtype=jnp.int32) + chunk_i * kc
            key = jnp.minimum(counts, float(MAX_COUNT)) * kcf + col[None, :]
            key = jnp.where(gcol[None, :] < k, key, float(MAX_COUNT) * kcf)
            m1 = jnp.min(key, axis=1)
            cb = jnp.minimum((m1 / kcf).astype(jnp.int32), MAX_COUNT)
            ci_local = (m1 - jnp.floor(m1 / kcf) * kcf).astype(jnp.int32)
            masked = jnp.where(
                col[None, :] == ci_local[:, None].astype(jnp.float32),
                float(MAX_COUNT) * kcf,
                key,
            )
            m2 = jnp.min(masked, axis=1)
            cn = jnp.minimum((m2 / kcf).astype(jnp.int32), MAX_COUNT)
            ci = ci_local + chunk_i * kc
            return merge_top2(carry, (cb, ci, cn)), None

        init = (
            jnp.full((b,), MAX_COUNT, dtype=jnp.int32),
            jnp.full((b,), k, dtype=jnp.int32),
            jnp.full((b,), MAX_COUNT, dtype=jnp.int32),
        )
        if n_chunks == 1:
            (best, bidx, nxt), _ = scan_body(init, (jnp.int32(0), cc[0]))
        else:
            (best, bidx, nxt), _ = jax.lax.scan(
                scan_body, init, (jnp.arange(n_chunks, dtype=jnp.int32), cc)
            )

        if packed2:
            # pure-ACGT rows by construction: the no-call gate ran host-side
            ok = (best <= max_mismatches) & (
                nxt - best >= min_mismatch_delta
            )
        else:
            if packed_masks:
                nocalls = jnp.sum((obs_masks == 15).astype(jnp.int32), axis=1)
            else:
                nocalls = jnp.sum(byte_is_nocall(obs_in), axis=1)
            ok = (
                (nocalls <= nocall_budget)
                & (best <= max_mismatches)
                & (nxt - best >= min_mismatch_delta)
            )
        out_dtype = jnp.uint8 if (compact_output and k < 255) else jnp.int32
        assigned = jnp.where(ok, bidx, k).astype(out_dtype)
        return assigned, best, nxt

    def assign(obs_bytes):
        return _assign(obs_bytes, compat_chunks_dev)

    return assign
