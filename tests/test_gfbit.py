"""Bit-sliced GF(2^m) arithmetic (ops/gfbit.py) vs the packed-integer
reference implementation (ops/gfint.py) — property tests over random
operands for every field the codecs use."""

import numpy as np
import jax.numpy as jnp
import pytest

from libpoporon_jax.ops import gfbit
from libpoporon_jax.ops.gfint import gf_mul_const_np

FIELDS = [
    (4, 0x13),
    (5, 0x25),
    (6, 0x43),
    (8, 0x11D),
    (8, 0x187),
    (10, 0x409),
    (16, 0x1100B),
]


def _rand(rng, m, shape):
    return rng.integers(0, 1 << m, shape, dtype=np.int64)


@pytest.mark.parametrize("m,poly", FIELDS)
def test_pack_roundtrip(m, poly):
    rng = np.random.default_rng(m)
    for B in (1, 31, 32, 33, 100, 256):
        x = _rand(rng, m, (3, B))
        planes = gfbit.pack_planes(jnp.asarray(x), m)
        assert planes.shape == (3, m, gfbit.words_for(B))
        back = np.asarray(gfbit.unpack_planes(planes, B))
        np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("m,poly", FIELDS)
def test_mul_matches_clmul(m, poly):
    rng = np.random.default_rng(m * 7 + 1)
    B = 200
    a = _rand(rng, m, (4, B))
    b = _rand(rng, m, (4, B))
    want = gf_mul_const_np(a, b, m, poly)
    got = gfbit.unpack_planes(
        gfbit.mul(
            gfbit.pack_planes(jnp.asarray(a), m),
            gfbit.pack_planes(jnp.asarray(b), m),
            m, poly,
        ),
        B,
    )
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("m,poly", FIELDS)
def test_mul_broadcasts(m, poly):
    rng = np.random.default_rng(m * 7 + 2)
    B = 64
    a = _rand(rng, m, (5, B))
    b = _rand(rng, m, (1, B))
    want = gf_mul_const_np(a, np.broadcast_to(b, a.shape), m, poly)
    got = gfbit.unpack_planes(
        gfbit.mul(
            gfbit.pack_planes(jnp.asarray(a), m),
            gfbit.pack_planes(jnp.asarray(b), m),
            m, poly,
        ),
        B,
    )
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("m,poly", FIELDS)
def test_square(m, poly):
    rng = np.random.default_rng(m * 7 + 3)
    B = 128
    a = _rand(rng, m, (B,))
    want = gf_mul_const_np(a, a, m, poly)
    got = gfbit.unpack_planes(
        gfbit.square(gfbit.pack_planes(jnp.asarray(a), m), m, poly), B
    )
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("m,poly", FIELDS)
def test_inv(m, poly):
    rng = np.random.default_rng(m * 7 + 4)
    B = 128
    a = _rand(rng, m, (B,))
    a[0] = 0  # inv(0) = 0
    ap = gfbit.pack_planes(jnp.asarray(a), m)
    got = gfbit.unpack_planes(gfbit.inv(ap, m, poly), B)
    prod = gf_mul_const_np(a, np.asarray(got), m, poly)
    want = np.where(a == 0, 0, 1)  # inv(0) = 0 -> product 0
    np.testing.assert_array_equal(prod, want)


def test_masks():
    rng = np.random.default_rng(9)
    for B in (1, 32, 65, 300):
        b = rng.integers(0, 2, (2, B)).astype(bool)
        w = gfbit.pack_mask(jnp.asarray(b))
        back = np.asarray(gfbit.unpack_mask(w, B))
        np.testing.assert_array_equal(back, b)


def test_nonzero_and_select():
    rng = np.random.default_rng(10)
    m, poly, B = 8, 0x11D, 96
    a = _rand(rng, m, (B,))
    a[::3] = 0
    ap = gfbit.pack_planes(jnp.asarray(a), m)
    nz = gfbit.nonzero_mask(ap)
    np.testing.assert_array_equal(np.asarray(gfbit.unpack_mask(nz, B)), a != 0)

    b = _rand(rng, m, (B,))
    bp = gfbit.pack_planes(jnp.asarray(b), m)
    sel = gfbit.unpack_planes(gfbit.select(nz, ap, bp), B)
    want = np.where(a != 0, a, b)
    np.testing.assert_array_equal(np.asarray(sel), want)


def test_xor_reduce():
    rng = np.random.default_rng(11)
    m, B = 8, 64
    x = _rand(rng, m, (7, B))
    planes = gfbit.pack_planes(jnp.asarray(x), m)  # [7, m, W]
    red = gfbit.xor_reduce(planes, axis=0)
    want = np.bitwise_xor.reduce(x, axis=0)
    np.testing.assert_array_equal(
        np.asarray(gfbit.unpack_planes(red, B)), want
    )


def test_packed_uint_arith():
    rng = np.random.default_rng(12)
    B, nbits = 100, 7
    a = rng.integers(0, 65, B)
    b = rng.integers(0, 65, B)
    ap = gfbit.pack_planes(jnp.asarray(a), nbits)
    bp = gfbit.pack_planes(jnp.asarray(b), nbits)
    add = np.asarray(gfbit.unpack_planes(gfbit.u_add(ap, bp), B))
    np.testing.assert_array_equal(add, (a + b) % 128)
    sub = np.asarray(gfbit.unpack_planes(gfbit.u_sub(ap, bp), B))
    np.testing.assert_array_equal(sub, (a - b) % 128)
    le = np.asarray(gfbit.unpack_mask(gfbit.u_le(ap, bp), B))
    np.testing.assert_array_equal(le, a <= b)


def test_u_broadcast():
    for val in (0, 1, 37, 127):
        planes = gfbit.u_broadcast(val, 7, 3)
        got = np.asarray(gfbit.unpack_planes(planes, 96))
        np.testing.assert_array_equal(got, np.full(96, val))
