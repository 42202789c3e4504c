"""Bit-sliced GF(2^m) arithmetic — the batch-packed elementwise fast path.

The reference's arithmetic layer is log/antilog tables (gf.c,
common.h:102-110); `ops/gfint.py` replaces those gathers with packed
carry-less multiplies (~3m int ops per element).  This module goes one
step further for the *data-dependent serial loops* (Berlekamp-Massey,
the Omega convolution, the erasure-locator product): it bit-slices the
BATCH axis, packing 32 codewords into each lane of a uint32 word, so a
GF(2^m) multiply becomes a fixed AND/XOR plane circuit

    c[i+j] ^= a_plane[i] & b_plane[j]        (m*m ANDs)
    fold c[k] for k >= m through the field polynomial (XORs)

costing ~(2m^2 + m*popcount(poly)) word-ops per 32 batch elements —
about 10x fewer elementwise ops *and* 4x less memory traffic than the packed
integer form.  Squaring and inversion (Itoh-Tsujii) are GF(2)-linear /
short multiply chains over the same planes.

Layout convention: a field-element tensor of logical shape [..., B]
becomes planes of shape [..., m, W] uint32 with W = ceil(B/32); batch
element ``w*32 + j`` lives in bit ``j`` of word ``w``.  Packed boolean
masks use the same bit order ([..., W] uint32).

All ops here are plain jnp bitwise primitives that XLA fuses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
_BITS = 32
_SHIFTS_NP = np.arange(_BITS, dtype=np.uint32)


def _shifts():
    # host constant — safe to embed in any trace
    return _SHIFTS_NP


def words_for(batch: int) -> int:
    return -(-batch // _BITS)


# --------------------------------------------------------------- packing
#
# Packing IS a 32x32 bit-matrix transpose per word group (element
# w*32+i's bit p moves to bit i of plane word p).  The butterfly
# exchange (Hacker's Delight 7-3) does it in 5 shift/mask/xor stages on
# the 32-row axis — ~30 word-ops per group instead of ~32 per plane for
# the naive broadcast form.


def _bit_transpose32(x):
    """[..., 32] uint32 rows -> bit-transposed [..., 32]: out row r's
    bit c = in row c's bit r.

    The raw butterfly exchanges along the anti-diagonal (both indices
    reversed); reversing the row axis before and after yields the
    straight transpose."""
    x = x[..., ::-1]
    j = 16
    mask = U32(0x0000FFFF)
    while j:
        xr = x.reshape(*x.shape[:-1], 32 // (2 * j), 2, j)
        lo = xr[..., 0, :]
        hi = xr[..., 1, :]
        t = (lo ^ (hi >> j)) & mask
        lo = lo ^ t
        hi = hi ^ (t << j)
        x = jnp.stack([lo, hi], axis=-2).reshape(*x.shape)
        j >>= 1
        if j:
            mask = mask ^ (mask << U32(j))
    return x[..., ::-1]


def _pad_last(x, total: int):
    pad = total - x.shape[-1]
    if pad:
        x = jnp.concatenate(
            [x, jnp.zeros((*x.shape[:-1], pad), dtype=x.dtype)], axis=-1
        )
    return x


def pack_mask(b):
    """bool [..., B] -> packed uint32 [..., W].  B padded with zeros."""
    B = b.shape[-1]
    W = words_for(B)
    br = _pad_last(b.astype(U32), W * _BITS).reshape(*b.shape[:-1], W, _BITS)
    return jnp.sum(br << _shifts(), axis=-1, dtype=U32)


def unpack_mask(w, batch: int):
    """packed uint32 [..., W] -> bool [..., batch]."""
    bits = (w[..., None] >> _shifts()) & U32(1)
    return bits.reshape(*w.shape[:-1], -1)[..., :batch].astype(bool)


def pack_planes(x, m: int):
    """int [..., B] -> planes uint32 [..., m, W] (plane p = bit p)."""
    B = x.shape[-1]
    W = words_for(B)
    xr = _pad_last(x.astype(U32), W * _BITS).reshape(*x.shape[:-1], W, _BITS)
    t = _bit_transpose32(xr)[..., :m]          # [..., W, m]
    return jnp.swapaxes(t, -1, -2)             # [..., m, W]


def unpack_planes(planes, batch: int):
    """planes uint32 [..., m, W] -> int32 [..., batch]."""
    m = planes.shape[-2]
    rows = jnp.swapaxes(planes, -1, -2)        # [..., W, m]
    rows = _pad_last(rows, _BITS)              # [..., W, 32]
    t = _bit_transpose32(rows)                 # [..., W, 32] element rows
    out = t.reshape(*planes.shape[:-2], -1)[..., :batch]
    return out.astype(jnp.int32)


# ------------------------------------------------------------ arithmetic


def mul(a, b, m: int, poly: int):
    """Elementwise bit-sliced GF(2^m) product.

    a, b: [..., m, W] planes (leading dims broadcast).  Returns planes
    of the broadcast shape.  Schoolbook carry-less multiply into 2m-1
    product planes, then fold planes >= m down through `poly` (which
    must include the x^m term), high plane first — the exact mod
    reduction of gfint.gf_mul in plane form.
    """
    ap = [a[..., i, :] for i in range(m)]
    bp = [b[..., j, :] for j in range(m)]
    c = [None] * (2 * m - 1)
    for i in range(m):
        for j in range(m):
            t = ap[i] & bp[j]
            k = i + j
            c[k] = t if c[k] is None else c[k] ^ t
    low = poly & ((1 << m) - 1)
    for k in range(2 * m - 2, m - 1, -1):
        for t in range(m):
            if (low >> t) & 1:
                c[k - m + t] = c[k - m + t] ^ c[k]
    return jnp.stack(c[:m], axis=-2)


@functools.lru_cache(maxsize=None)
def _square_map(m: int, poly: int):
    """Host table: out plane k = XOR of in planes listed in rows[k]
    (squaring is GF(2)-linear: basis alpha^i -> alpha^{2i} mod poly)."""
    sq = []
    for i in range(m):
        v = 1 << (2 * i)
        for k in range(2 * m - 2, m - 1, -1):
            if (v >> k) & 1:
                v ^= poly << (k - m)
        sq.append(v)
    rows = [[i for i in range(m) if (sq[i] >> k) & 1] for k in range(m)]
    return rows


def square(a, m: int, poly: int):
    """Elementwise bit-sliced square (linear — XOR plane recombination)."""
    rows = _square_map(m, poly)
    ap = [a[..., i, :] for i in range(m)]
    out = []
    for k in range(m):
        acc = None
        for i in rows[k]:
            acc = ap[i] if acc is None else acc ^ ap[i]
        out.append(acc if acc is not None else jnp.zeros_like(ap[0]))
    return jnp.stack(out, axis=-2)


def frob(a, s: int, m: int, poly: int):
    """a^(2^s) — s repeated (linear) squarings."""
    for _ in range(s):
        a = square(a, m, poly)
    return a


def inv(a, m: int, poly: int):
    """Elementwise inverse a^(2^m - 2) by Itoh-Tsujii.  inv(0) = 0.

    a^(2^e - 1) is built recursively: for e = 2h (+1),
    a^(2^{2h}-1) = (a^(2^h-1))^{2^h} * (a^(2^h-1)), with one extra
    square-and-multiply step for odd e; one final squaring then gives
    a^(2^m - 2) = (a^(2^{m-1} - 1))^2.
    """

    def pow_2e_m1(e: int):
        if e == 1:
            return a
        h = e // 2
        y = pow_2e_m1(h)
        y = mul(frob(y, h, m, poly), y, m, poly)  # a^(2^{2h} - 1)
        if e % 2:
            y = mul(square(y, m, poly), a, m, poly)  # a^(2^{2h+1} - 1)
        return y

    return square(pow_2e_m1(m - 1), m, poly)


def xor_reduce(planes, axis: int = 0):
    """XOR fold over a coefficient axis."""
    return jax.lax.reduce(
        planes, np.uint32(0), jax.lax.bitwise_xor, (axis,)
    )


def nonzero_mask(a):
    """[..., m, W] -> packed mask [..., W]: bit set where element != 0."""
    return jax.lax.reduce(
        a, np.uint32(0), jax.lax.bitwise_or, (a.ndim - 2,)
    )


def select(mask_w, a, b):
    """Packed-mask select: (a & mask) | (b & ~mask).

    mask_w: [..., W] broadcastable against a/b's [..., m, W] after a
    plane-axis insert."""
    mw = mask_w[..., None, :]
    return (a & mw) | (b & ~mw)


# ----------------------------------------- packed small-uint arithmetic
#
# Loop-control integers (BM's poly_deg, erasure counts) stay bit-sliced
# too: planes [nbits, W] with plane k = bit k, so per-iteration
# compares/updates are a handful of word-ops instead of unpack/
# repack round trips through [B] vectors.


def u_broadcast(val, nbits: int, W: int):
    """Scalar (python int or traced int32) -> planes [nbits, W]:
    plane k is all-ones where bit k of val is set."""
    v = jnp.asarray(val, dtype=U32)
    ks = jnp.arange(nbits, dtype=U32)
    bits = (v >> ks) & U32(1)                     # [nbits]
    return jnp.broadcast_to(
        (U32(0) - bits)[:, None], (nbits, W)
    )  # 0 -> 0x0, 1 -> 0xFFFFFFFF


def u_add(a, b):
    """Packed ripple-carry add (mod 2^nbits); a, b: [nbits, W]."""
    nbits = a.shape[0]
    out = []
    c = jnp.zeros_like(a[0])
    for k in range(nbits):
        ak, bk = a[k], b[k]
        out.append(ak ^ bk ^ c)
        c = (ak & bk) | (c & (ak ^ bk))
    return jnp.stack(out, axis=0)


def u_sub(a, b):
    """Packed a - b (mod 2^nbits): a + ~b + 1 with a ripple carry."""
    nbits = a.shape[0]
    out = []
    c = ~jnp.zeros_like(a[0])                     # carry-in 1 everywhere
    for k in range(nbits):
        ak, bk = a[k], ~b[k]
        out.append(ak ^ bk ^ c)
        c = (ak & bk) | (c & (ak ^ bk))
    return jnp.stack(out, axis=0)


def u_le(a, b):
    """Packed mask: a <= b (unsigned).  Computes the borrow chain of
    b - a; no final borrow means a <= b."""
    nbits = a.shape[0]
    d = jnp.zeros_like(a[0])
    for k in range(nbits):
        bk, ak = b[k], a[k]
        d = (~bk & ak) | (d & ~(bk ^ ak))
    return ~d
