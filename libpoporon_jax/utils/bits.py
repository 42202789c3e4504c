"""MSB-first bit pack/unpack helpers (host NumPy + device jnp).

The reference library addresses bits MSB-first within each byte
(/root/reference/src/ldpc.c:71-86).  These helpers convert between
byte tensors and 0/1 bit tensors with that convention, batched.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def unpack_np(data: np.ndarray, nbits: int | None = None) -> np.ndarray:
    """uint8 [..., nbytes] -> uint8 bits [..., nbytes*8] MSB-first."""
    bits = np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1, bitorder="big")
    if nbits is not None:
        bits = bits[..., :nbits]
    return bits


def pack_np(bits: np.ndarray) -> np.ndarray:
    """0/1 bits [..., nbits] -> uint8 [..., ceil(nbits/8)] MSB-first."""
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1, bitorder="big")


def unpack_jnp(data, nbits: int | None = None):
    """uint8 [..., nbytes] -> int8 bits [..., nbytes*8 (or nbits)] MSB-first.

    Implemented as shift+mask (fused elementwise; no gather).
    """
    data = data.astype(jnp.uint8)
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)  # MSB first
    bits = (data[..., :, None] >> shifts) & jnp.uint8(1)
    bits = bits.reshape(*data.shape[:-1], data.shape[-1] * 8)
    if nbits is not None:
        bits = bits[..., :nbits]
    return bits.astype(jnp.int8)


def pack_jnp(bits):
    """0/1 bits [..., nbits] -> uint8 [..., ceil(nbits/8)] MSB-first."""
    nbits = bits.shape[-1]
    nbytes = (nbits + 7) // 8
    pad = nbytes * 8 - nbits
    if pad:
        bits = jnp.concatenate(
            [bits, jnp.zeros((*bits.shape[:-1], pad), dtype=bits.dtype)], axis=-1
        )
    b = bits.reshape(*bits.shape[:-1], nbytes, 8).astype(jnp.uint8)
    weights = (jnp.uint8(1) << jnp.arange(7, -1, -1, dtype=jnp.uint8))
    return (b * weights).sum(axis=-1).astype(jnp.uint8)
