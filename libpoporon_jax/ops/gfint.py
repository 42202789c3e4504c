"""Packed-integer GF(2^m) arithmetic — the gather-free device fast path.

Log/antilog table lookups (the reference's entire arithmetic layer,
gf.c + common.h:102-110) would be per-element gathers on the device.
Instead, field elements stay in NORMAL domain as packed integers and
multiplication is carry-less multiply + polynomial reduction, unrolled
into ~3m fused elementwise int ops (zero memory traffic beyond the
operands):

    c = XOR_j ((a << j) * bit_j(b))          # schoolbook clmul
    for k = 2m-2 .. m: c ^= bit_k(c) * (poly << (k-m))   # mod reduction

Small per-element lookups that cannot be avoided (inverses, powers of
alpha by data-dependent exponent) use fused broadcast-compare-select
against a <=2^m-entry table — XLA fuses the compare/select/reduce into
one pass, no gather op is emitted.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def gf_mul(a, b, m: int, poly: int):
    """Elementwise GF(2^m) product of packed int32 tensors (any shape)."""
    a = a.astype(jnp.int32)
    b = b.astype(jnp.int32)
    c = jnp.zeros_like(a)
    for j in range(m):
        c = c ^ ((a << j) * ((b >> j) & 1))
    for k in range(2 * m - 2, m - 1, -1):
        c = c ^ (((c >> k) & 1) * (poly << (k - m)))
    return c


def gf_mul_const_np(a: np.ndarray, b: np.ndarray, m: int, poly: int) -> np.ndarray:
    """Host NumPy twin of gf_mul (used for table construction)."""
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    c = np.zeros_like(a)
    for j in range(m):
        c = c ^ ((a << j) * ((b >> j) & 1))
    for k in range(2 * m - 2, m - 1, -1):
        c = c ^ (((c >> k) & 1) * (poly << (k - m)))
    return c


def table_select(table, idx):
    """Gather-free lookup: out[...] = table[idx[...]].

    table: [N] (device or numpy), idx int tensor with values in [0, N).
    Lowers to a fused broadcast-compare-select-reduce, never a gather.
    Cost ~ N * idx.size fused ops — use for small N and moderate idx.
    """
    table = jnp.asarray(table, dtype=jnp.int32)
    n = table.shape[0]
    ar = jnp.arange(n, dtype=jnp.int32)
    return jnp.sum(
        jnp.where(idx[..., None] == ar, table, 0), axis=-1, dtype=jnp.int32
    )


def onehot_select(values, positions, out_slots):
    """out[..., t] = sum_p values[..., p] * (rank[..., p] == t).

    Extracts, in scan order, the values at `positions` (a 0/1 mask over
    the last axis) into `out_slots` compacted slots.  Replaces
    sort-based compaction (gather-free; fused einsum).
    Returns float32 — cast at the call site.
    """
    cum = jnp.cumsum(positions.astype(jnp.int32), axis=-1)
    rank = jnp.where(positions, cum - 1, -1)
    oh = (rank[..., None] == jnp.arange(out_slots)).astype(jnp.float32)
    return jnp.einsum("...p,...pt->...t", values.astype(jnp.float32), oh)


def scatter_mod2(values, index, length):
    """out[..., p] = XOR over t of values[..., t] where index[..., t] == p.

    Indices are distinct per element (error locations), so a float sum
    is exact and equals the XOR-free placement.  index < 0 drops.
    Returns float32 [..., length].
    """
    oh = (index[..., None] == jnp.arange(length)).astype(jnp.float32)
    return jnp.einsum("...t,...tp->...p", values.astype(jnp.float32), oh)
