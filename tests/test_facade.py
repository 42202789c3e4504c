"""Unified facade tests (spec: reference tests/test_unified.c,
test_codec.c, test_invalid.c)."""

import numpy as np
import pytest

import libpoporon_jax as pp
from libpoporon_jax.config import FecType, LdpcRate

_CODECS = {}


def rs_codec():
    if "rs" not in _CODECS:
        _CODECS["rs"] = pp.create(pp.rs_config_default())
    return _CODECS["rs"]


class TestRSFacade:
    def test_getters(self):
        c = rs_codec()
        assert c.fec_type == FecType.RS
        assert c.parity_size == 32
        assert c.info_size == 223

    def test_encode_nontrivial(self):
        c = rs_codec()
        data = np.zeros((1, 223), dtype=np.uint8)
        data[0, 0] = 1
        parity = np.asarray(c.encode(data).parity)
        assert parity.any()  # non-trivial parity

    @pytest.mark.parametrize("nerr", list(range(1, 17)))
    def test_correction_sweep(self, nerr):
        """1..t errors corrected (test_codec.c:206-218)."""
        c = rs_codec()
        rng = np.random.default_rng(nerr)
        data = rng.integers(0, 256, (1, 223), dtype=np.uint8)
        parity = np.asarray(c.encode(data).parity)
        bad = data.copy()
        pos = rng.choice(223, nerr, replace=False)
        for p in pos:
            bad[0, p] ^= rng.integers(1, 256)
        res = c.decode(bad, parity)
        assert bool(np.asarray(res.ok).all())
        np.testing.assert_array_equal(np.asarray(res.data), data)
        assert int(np.asarray(res.corrected)[0]) == nerr

    def test_t_plus_one_fails(self):
        c = rs_codec()
        rng = np.random.default_rng(99)
        data = rng.integers(0, 256, (1, 223), dtype=np.uint8)
        parity = np.asarray(c.encode(data).parity)
        bad = data.copy()
        for p in rng.choice(223, 17, replace=False):
            bad[0, p] ^= rng.integers(1, 256)
        res = c.decode(bad, parity)
        assert not bool(np.asarray(res.ok).any())

    def test_single_codeword_api(self):
        """README example: encode, flip 2 symbols, decode (1-D API)."""
        c = rs_codec()
        rng = np.random.default_rng(0)
        data = rng.integers(0, 256, 223, dtype=np.uint8)
        parity = np.asarray(c.encode(data).parity)
        assert parity.shape == (32,)
        bad = data.copy()
        bad[10] ^= 0xFF
        bad[100] ^= 0x55
        res = c.decode(bad, parity)
        assert bool(res.ok)
        np.testing.assert_array_equal(np.asarray(res.data), data)
        assert int(res.corrected) == 2

    def test_erasure_api(self):
        c = rs_codec()
        rng = np.random.default_rng(5)
        data = rng.integers(0, 256, (2, 223), dtype=np.uint8)
        parity = np.asarray(c.encode(data).parity)
        pos = np.array([7, 50, 100], dtype=np.int32)
        bad = data.copy()
        bad[:, pos] ^= 0xFF
        eras = pp.Erasure.from_positions(32, pos)
        res = c.decode(bad, parity, erasures=eras)
        assert bool(np.asarray(res.ok).all())
        np.testing.assert_array_equal(np.asarray(res.data), data)


class TestLDPCFacadeUnit:
    def test_default_config_quirk_soft_without_llr(self):
        """use_soft_decode=True + no LLR falls back to hard decode."""
        cfg = pp.ldpc_config_default(64, LdpcRate.RATE_1_2)
        assert cfg.use_soft_decode
        c = pp.create(cfg)
        rng = np.random.default_rng(1)
        data = rng.integers(0, 256, (2, 64), dtype=np.uint8)
        enc = c.encode(data)
        res = c.decode(np.asarray(enc.data), np.asarray(enc.parity))
        assert bool(np.asarray(res.ok).all())
        np.testing.assert_array_equal(np.asarray(res.data), data)

    def test_getters(self):
        c = pp.create(pp.ldpc_config_default(64, LdpcRate.RATE_1_2))
        assert c.parity_size == 64
        assert c.info_size == 64
        assert c.fec_type == FecType.LDPC

    def test_corrected_num_is_iterations(self):
        """LDPC writes iterations into corrected_num (decode.c:535-537)."""
        cfg = pp.LdpcConfig(block_size=64, rate=LdpcRate.RATE_1_2)
        c = pp.create(cfg)
        rng = np.random.default_rng(3)
        data = rng.integers(0, 256, (2, 64), dtype=np.uint8)
        enc = c.encode(data)
        bad = np.asarray(enc.data).copy()
        bad[:, 0] ^= 0x80
        res = c.decode(bad, np.asarray(enc.parity))
        assert bool(np.asarray(res.ok).all())
        assert (np.asarray(res.corrected) >= 1).all()


class TestBCHFacadeUnit:
    def test_getters(self):
        c = pp.create(pp.bch_config_default())
        assert c.fec_type == FecType.BCH
        assert c.info_size == 1   # ceil(5/8)
        assert c.parity_size == 2  # ceil(10/8)

    def test_roundtrip_3_bit_errors(self):
        c = pp.create(pp.bch_config_default())
        data = np.arange(32, dtype=np.uint8).reshape(32, 1)
        parity = np.asarray(c.encode(data).parity)
        bad = data ^ np.uint8(0x07)  # 3 bit errors in the data word
        res = c.decode(bad, parity)
        assert bool(np.asarray(res.ok).all())
        np.testing.assert_array_equal(np.asarray(res.data), data)
        assert (np.asarray(res.corrected) == 3).all()


class TestInvalid:
    def test_unknown_config(self):
        with pytest.raises(TypeError):
            pp.create(object())

    def test_rs_bad_symbol_size(self):
        with pytest.raises(Exception):
            pp.create(pp.RSConfig(symbol_size=0))

    def test_rs_zero_primitive(self):
        with pytest.raises(Exception):
            pp.create(pp.RSConfig(primitive_element=0))

    def test_bch_bad_t(self):
        with pytest.raises(Exception):
            pp.create(pp.BchConfig(correction_capability=0))
