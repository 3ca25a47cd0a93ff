"""Device-side byte -> IUPAC-mask encoding without gathers.

A chain of ~20 vectorized compares instead of ``lut[bytes]``: the compares
fuse into neighboring elementwise ops, where a table lookup lowers to a
gather.  Semantics identical to :data:`fqtk_tpu.core.encoding.ENCODE_LUT`:

- no-call bytes ``N``/``n``/``.`` -> 15
- otherwise uppercase, then IUPAC mask (0 for non-IUPAC bytes)
"""

from __future__ import annotations

_TABLE = [
    ("A", 1), ("C", 2), ("G", 4), ("T", 8), ("U", 8),
    ("M", 3), ("R", 5), ("W", 9), ("S", 6), ("Y", 10), ("K", 12),
    ("V", 7), ("H", 11), ("D", 13), ("B", 14), ("N", 15),
]


def byte_to_mask(obs_bytes):
    """uint8 byte array -> int32 4-bit mask array (same shape)."""
    import jax.numpy as jnp

    b = obs_bytes.astype(jnp.int32)
    upper = jnp.where((b >= 97) & (b <= 122), b - 32, b)
    m = jnp.zeros_like(b)
    for ch, v in _TABLE:
        m = m + v * (upper == ord(ch)).astype(jnp.int32)
    # '.' is a no-call (encodes to 15) though it is not a letter
    return jnp.where(b == ord("."), 15, m)


def byte_is_nocall(obs_bytes):
    """uint8 byte array -> int32 0/1 no-call indicator (N, n, '.')."""
    import jax.numpy as jnp

    b = obs_bytes.astype(jnp.int32)
    return ((b == 78) | (b == 110) | (b == 46)).astype(jnp.int32)


def unpack_nib4(obs_in, length):
    """Unpack ``[B, ceil(L/2)]`` 4-bit-mask bytes (low nibble = even
    position) to ``[B, L]`` int32 masks — the device side of the native
    engine's nib4 transfer layout."""
    import jax.numpy as jnp

    b = obs_in.shape[0]
    lo = (obs_in & 0xF).astype(jnp.int32)
    hi = (obs_in >> 4).astype(jnp.int32)
    return jnp.stack([lo, hi], axis=-1).reshape(b, -1)[:, :length]


def unpack_bit2(obs_in, length):
    """Unpack ``[B, ceil(L/4)]`` 2-bit-code bytes (lowest bit pair = first
    position) to ``[B, L]`` int32 codes in 0..3 — the device side of the
    native engine's bit2 transfer layout.  The single source of truth for
    this layout; the XLA and Pallas matchers must never diverge on it."""
    import jax.numpy as jnp

    b = obs_in.shape[0]
    parts = [((obs_in >> (2 * i)) & 3).astype(jnp.int32) for i in range(4)]
    return jnp.stack(parts, axis=-1).reshape(b, -1)[:, :length]
