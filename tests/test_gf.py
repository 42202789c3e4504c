"""GF(2^m) table tests (spec: reference tests/test_gf.c)."""

import numpy as np
import pytest

from libpoporon_jax.ops.gf import GF, GFError

import oracle


def test_bounds_rejected():
    with pytest.raises(GFError):
        GF(0, 0x11D)
    with pytest.raises(GFError):
        GF(17, 0x11D)


def test_non_primitive_rejected():
    # x^8 + 1 (0x101) is not primitive over GF(2^8)
    with pytest.raises(GFError):
        GF(8, 0x101)


def test_sentinels():
    gf = GF(8, 0x11D)
    assert gf.exp2log[0] == 255
    assert gf.log2exp[255] == 0
    assert gf.log2exp[0] == 1  # alpha^0 = 1


def test_gf_mod_identities():
    gf = GF(8, 0x11D)
    assert gf.gf_mod(0) == 0
    assert gf.gf_mod(254) == 254
    assert gf.gf_mod(255) == 0
    assert gf.gf_mod(256) == 1  # wraparound (reference test_gf.c:61-76)
    assert gf.gf_mod(510) == 0


def test_mul_matrix_matches_table_mul():
    gf = GF(8, 0x11D)
    rng = np.random.default_rng(0)
    for c in rng.integers(0, 256, size=16):
        M = gf.mul_matrix(int(c))
        for x in rng.integers(0, 256, size=16):
            xb = np.array([(int(x) >> (7 - j)) & 1 for j in range(8)], dtype=np.uint8)
            yb = xb @ M % 2
            y = 0
            for k in range(8):
                y |= int(yb[k]) << (7 - k)
            assert y == gf.mul(int(x), int(c))


@pytest.mark.skipif(not oracle.available(), reason="reference oracle unavailable")
@pytest.mark.parametrize("m,poly", [(4, 0x13), (5, 0x25), (6, 0x43), (8, 0x11D)])
def test_tables_bit_exact_vs_reference(m, poly):
    gf = GF(m, poly)
    ref = oracle.gf_tables(m, poly)
    assert ref is not None
    log2exp, exp2log = ref
    np.testing.assert_array_equal(gf.log2exp, log2exp)
    np.testing.assert_array_equal(gf.exp2log, exp2log)


@pytest.mark.skipif(not oracle.available(), reason="reference oracle unavailable")
def test_gf_mod_exhaustive_vs_reference():
    gf = GF(8, 0x11D)
    L = oracle.lib()
    gfp = L.poporon_gf_create(8, 0x11D)
    for v in range(0, 65536, 257):
        assert gf.gf_mod(v) == L.poporon_gf_mod(gfp, v)
    L.poporon_gf_destroy(gfp)
