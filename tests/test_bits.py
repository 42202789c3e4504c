"""Bit pack/unpack helpers (MSB-first, ldpc.c:71-86 convention)."""

import numpy as np
import pytest

import jax.numpy as jnp

from libpoporon_jax.utils import bits


@pytest.mark.parametrize("shape", [(3,), (2, 5), (4, 1)])
def test_roundtrip_np(shape):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(bits.pack_np(bits.unpack_np(data)), data)


def test_jnp_matches_np():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (4, 7), dtype=np.uint8)
    np.testing.assert_array_equal(
        np.asarray(bits.unpack_jnp(data)), bits.unpack_np(data)
    )
    b = bits.unpack_np(data)
    np.testing.assert_array_equal(np.asarray(bits.pack_jnp(jnp.asarray(b))),
                                  bits.pack_np(b))


def test_nbits_truncation():
    data = np.array([0b10110001], dtype=np.uint8)
    np.testing.assert_array_equal(bits.unpack_np(data, 4), [1, 0, 1, 1])
    np.testing.assert_array_equal(
        np.asarray(bits.unpack_jnp(data, 4)), [1, 0, 1, 1]
    )


def test_pack_pads_partial_byte():
    b = np.array([[1, 0, 1]], dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(bits.pack_jnp(jnp.asarray(b))),
                                  [[0b10100000]])


def test_native_matches_numpy():
    from libpoporon_jax.utils import native
    if not native.available():
        pytest.skip("native core unavailable")
    import ctypes as ct
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (5, 9), dtype=np.uint8)
    L = native._load()
    out = np.zeros((5, 70), dtype=np.uint8)
    L.pptpu_unpack_bits(np.ascontiguousarray(data), out, 5, 9, 70)
    np.testing.assert_array_equal(out, bits.unpack_np(data, 70))
    packed = np.zeros((5, 9), dtype=np.uint8)
    L.pptpu_pack_bits(np.ascontiguousarray(out), packed, 5, 70, 9)
    ref = bits.pack_np(np.pad(out, ((0, 0), (0, 2))))
    np.testing.assert_array_equal(packed, ref)
