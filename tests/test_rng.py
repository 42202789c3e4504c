"""RNG tests — determinism + bit-exactness vs the reference C library
(spec: reference tests/test_rng.c)."""

import numpy as np
import pytest

from libpoporon_jax.utils.rng import Xoshiro128pp

import oracle


def test_determinism_same_seed():
    a = Xoshiro128pp(12345)
    b = Xoshiro128pp(12345)
    assert [a.next_u32() for _ in range(100)] == [b.next_u32() for _ in range(100)]


def test_seed_divergence():
    a = Xoshiro128pp(1)
    b = Xoshiro128pp(2)
    assert [a.next_u32() for _ in range(10)] != [b.next_u32() for _ in range(10)]


def test_bulk_matches_scalar():
    a = Xoshiro128pp(777)
    b = Xoshiro128pp(777)
    bulk = a.draw_u32(257)
    scalar = np.array([b.next_u32() for _ in range(257)], dtype=np.uint32)
    np.testing.assert_array_equal(bulk, scalar)


def test_seed_bytes_little_endian():
    assert Xoshiro128pp(0x04030201).next_u32() == \
        Xoshiro128pp(b"\x01\x02\x03\x04").next_u32()
    # partial seeds zero-extend
    assert Xoshiro128pp(0x01).next_u32() == Xoshiro128pp(b"\x01").next_u32()


@pytest.mark.skipif(not oracle.available(), reason="reference oracle unavailable")
@pytest.mark.parametrize("seed", [0, 1, 12345, 0xDEADBEEF, 0xFFFFFFFF])
@pytest.mark.parametrize("size", [4, 64, 1021, 4096])
def test_stream_bit_exact_vs_reference(seed, size):
    ours = Xoshiro128pp(seed).fill_bytes(size)
    ref = oracle.rng_stream(seed, size)
    assert ours == ref


@pytest.mark.skipif(not oracle.available(), reason="reference oracle unavailable")
def test_odd_sizes_vs_reference():
    for size in (1, 2, 3, 5, 7, 13, 31):
        assert Xoshiro128pp(42).fill_bytes(size) == oracle.rng_stream(42, size)
