"""Native (C++) host-core vs pure-Python equivalence.

The native library (libpoporon_jax/native/core.cpp) accelerates
host-side structure construction; every entry point must be
value-identical to the Python/NumPy implementation it replaces —
these tests pin that contract directly (the oracle suite only covers
it transitively through whichever path `native.available()` selects).
"""

import numpy as np
import pytest

from libpoporon_jax.utils import native
from libpoporon_jax.utils.rng import Xoshiro128pp
from libpoporon_jax.models import ldpc as ldpc_mod
from libpoporon_jax.config import LdpcConfig, LdpcMatrixType, LdpcRate

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native core not built"
)


@pytest.mark.parametrize("seed,count", [(0, 1), (1, 17), (0xDEADBEEF, 4096)])
def test_xoshiro_fill_u32(seed, count):
    ours = native.xoshiro_fill_u32(seed, count)
    ref = Xoshiro128pp(seed).draw_u32(count)
    np.testing.assert_array_equal(ours, ref.astype(np.uint32))


@pytest.mark.parametrize("seed,n", [(3, 1), (3, 2), (7, 97), (123, 1024)])
def test_fisher_yates(seed, n):
    """Matches the reference shuffle loop (ldpc.c:196-209 semantics)."""
    ours = native.fisher_yates(seed, n)
    ref = np.arange(n, dtype=np.int64)
    rng = Xoshiro128pp(seed)
    for i in range(n - 1, 0, -1):
        j = rng.next_u32() % (i + 1)
        ref[i], ref[j] = ref[j], ref[i]
    np.testing.assert_array_equal(ours.astype(np.int64), ref)


def _python_random_csr(seed, info_bits, parity_bits, cw):
    """The pure-Python CSR build path of LdpcStructure._build_random."""
    rng = Xoshiro128pp(seed)
    draws = rng.draw_u32(info_bits * cw)
    targets = (draws % np.uint32(parity_bits)).astype(np.int64)
    info_cols = np.repeat(np.arange(info_bits, dtype=np.int64), cw)
    return targets, info_cols


@pytest.mark.parametrize(
    "block,rate,cw",
    [(32, LdpcRate.RATE_1_2, 3), (64, LdpcRate.RATE_1_3, 5),
     (128, LdpcRate.RATE_3_4, 8)],
)
def test_ldpc_build_random_equivalence(block, rate, cw, monkeypatch):
    cfg = LdpcConfig(block_size=block, rate=rate, column_weight=cw, seed=42)

    s_native = ldpc_mod.LdpcStructure(cfg)

    # force the Python path and rebuild
    monkeypatch.setattr(native, "ldpc_build_random", lambda *a, **k: None)
    ldpc_mod._STRUCT_CACHE.clear()
    s_python = ldpc_mod.LdpcStructure(cfg)

    np.testing.assert_array_equal(s_native.row_ptr, s_python.row_ptr)
    np.testing.assert_array_equal(s_native.col_idx, s_python.col_idx)
    assert s_native.num_edges_used == s_python.num_edges_used
    ldpc_mod._STRUCT_CACHE.clear()


@pytest.mark.parametrize(
    "block,rate,lifting",
    [(32, LdpcRate.RATE_1_2, 0), (64, LdpcRate.RATE_1_2, 16),
     (128, LdpcRate.RATE_1_3, 0)],
)
def test_ldpc_build_qc_equivalence(block, rate, lifting, monkeypatch):
    cfg = LdpcConfig(
        block_size=block, rate=rate,
        matrix_type=LdpcMatrixType.QC_RANDOM,
        lifting_factor=lifting, seed=7,
    )
    s_native = ldpc_mod.LdpcStructure(cfg)

    monkeypatch.setattr(native, "ldpc_build_qc", lambda *a, **k: None)
    ldpc_mod._STRUCT_CACHE.clear()
    s_python = ldpc_mod.LdpcStructure(cfg)

    np.testing.assert_array_equal(s_native.row_ptr, s_python.row_ptr)
    np.testing.assert_array_equal(s_native.col_idx, s_python.col_idx)
    ldpc_mod._STRUCT_CACHE.clear()
