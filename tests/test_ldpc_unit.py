"""LDPC unit tests: bounds, structure invariants, round trips, burst
resistance (spec: reference tests/test_ldpc.c)."""

import numpy as np
import pytest

from libpoporon_jax.config import LdpcConfig, LdpcMatrixType, LdpcRate
from libpoporon_jax.models.ldpc import (
    LDPCCodec,
    LdpcError,
    LdpcStructure,
    get_structure,
)


def _cfg(block=64, rate=LdpcRate.RATE_1_2, **kw):
    return LdpcConfig(block_size=block, rate=rate, **kw)


_CODECS: dict = {}


def codec(block=64, rate=LdpcRate.RATE_1_2, **kw):
    key = (block, rate, tuple(sorted(kw.items())))
    c = _CODECS.get(key)
    if c is None:
        c = LDPCCodec(_cfg(block, rate, **kw))
        _CODECS[key] = c
    return c


class TestBounds:
    def test_block_too_small(self):
        with pytest.raises(LdpcError):
            LdpcStructure(_cfg(block=8))

    def test_block_too_large(self):
        with pytest.raises(LdpcError):
            LdpcStructure(_cfg(block=8196))

    def test_block_not_multiple_of_4(self):
        with pytest.raises(LdpcError):
            LdpcStructure(_cfg(block=65))

    def test_bad_rate(self):
        with pytest.raises(LdpcError):
            LdpcStructure(LdpcConfig(block_size=64, rate=100))

    def test_col_weight_clamped(self):
        s = LdpcStructure(_cfg(column_weight=1))
        assert s.col_weight == 3
        s = LdpcStructure(_cfg(column_weight=99))
        assert s.col_weight == 8


class TestStructure:
    @pytest.mark.parametrize("rate", list(LdpcRate))
    def test_rate_dimensions(self, rate):
        s = get_structure(_cfg(block=96, rate=rate))
        info_num, parity_num = rate.ratio
        assert s.info_bits == 96 * 8
        assert s.parity_bits == s.info_bits * parity_num // info_num
        assert s.codeword_bits == s.info_bits + s.parity_bits

    def test_info_columns_have_exact_col_weight(self):
        s = get_structure(_cfg(column_weight=4))
        counts = np.bincount(s.col_idx, minlength=s.codeword_bits)
        np.testing.assert_array_equal(
            counts[: s.info_bits], np.full(s.info_bits, 4)
        )

    def test_staircase_parity_edges(self):
        s = get_structure(_cfg())
        # parity column i connects checks i and i+1 => degrees 2, last 1
        counts = np.bincount(s.col_idx, minlength=s.codeword_bits)
        pc = counts[s.info_bits :]
        assert pc[-1] == 1
        assert (pc[:-1] == 2).all()
        assert s.num_edges_used == s.info_bits * s.col_weight + 2 * s.parity_bits - 1

    def test_seed_determinism(self):
        a = LdpcStructure(_cfg(seed=123))
        b = LdpcStructure(_cfg(seed=123))
        c = LdpcStructure(_cfg(seed=124))
        np.testing.assert_array_equal(a.col_idx, b.col_idx)
        assert not np.array_equal(a.col_idx, c.col_idx)

    def test_qc_structure(self):
        s = get_structure(_cfg(matrix_type=LdpcMatrixType.QC_RANDOM))
        assert s.num_edges_used <= s.info_bits * 3 + 2 * s.parity_bits - 1
        assert s.row_ptr[-1] == s.num_edges_used


class TestEncodeDecode:
    def test_encode_satisfies_checks(self):
        c = codec()
        rng = np.random.default_rng(0)
        info = rng.integers(0, 256, (8, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        assert np.asarray(c.check(cw)).all()

    def test_decode_clean_zero_iterations(self):
        c = codec()
        rng = np.random.default_rng(1)
        info = rng.integers(0, 256, (4, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        ok, out, iters = map(np.asarray, c.decode_hard(cw))
        assert ok.all()
        assert (iters == 0).all()
        np.testing.assert_array_equal(out, cw)

    @pytest.mark.parametrize("nflip", [1, 3, 8])
    def test_decode_corrects_bit_errors(self, nflip):
        c = codec(block=128)
        rng = np.random.default_rng(nflip)
        info = rng.integers(0, 256, (8, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        bad = cw.copy()
        for b in range(8):
            for p in rng.choice(c.codeword_bits, nflip, replace=False):
                bad[b, p // 8] ^= 1 << (7 - (p % 8))
        ok, out, iters = map(np.asarray, c.decode_hard(bad))
        assert ok.all()
        assert (iters >= 1).all()
        np.testing.assert_array_equal(out, cw)

    def test_decode_3_byte_errors_block256(self):
        """Mirror of reference test_ldpc.c:333-379: block 256, three
        byte errors, 100 iterations."""
        c = codec(block=256)
        info = ((np.arange(256) * 17 + 23) & 0xFF).astype(np.uint8)[None]
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        bad = cw.copy()
        bad[0, 5] ^= 0xAB
        bad[0, 50] ^= 0xCD
        bad[0, 100] ^= 0xEF
        assert not bool(np.asarray(c.check(bad)).all())
        ok, out, iters = map(np.asarray, c.decode_hard(bad, max_iterations=100))
        assert ok.all()
        assert (iters > 0).all()
        np.testing.assert_array_equal(out, cw)

    @pytest.mark.parametrize("rate", list(LdpcRate))
    def test_all_rates_roundtrip(self, rate):
        c = codec(block=96, rate=rate)
        rng = np.random.default_rng(int(rate))
        info = rng.integers(0, 256, (2, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        bad = cw.copy()
        bad[:, 1] ^= 0x01
        ok, out, iters = map(np.asarray, c.decode_hard(bad))
        assert ok.all()
        np.testing.assert_array_equal(out, cw)

    def test_soft_decode_flipped_llrs(self):
        from libpoporon_jax.utils import bits as bitutils
        c = codec(block=64)
        rng = np.random.default_rng(2)
        info = rng.integers(0, 256, (4, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        cb = bitutils.unpack_np(cw, c.codeword_bits)
        llr = np.where(cb == 1, -100, 100).astype(np.int8)
        for b in range(4):
            pos = rng.choice(c.codeword_bits, 3, replace=False)
            llr[b, pos] = -llr[b, pos]
        ok, out, iters = map(np.asarray, c.decode_soft(llr))
        assert ok.all()
        np.testing.assert_array_equal(out, cw)

    def test_interleave_roundtrip(self):
        c = codec(block=64, use_inner_interleave=True)
        rng = np.random.default_rng(4)
        cw = rng.integers(0, 256, (4, c.codeword_bytes), dtype=np.uint8)
        # mask tail bits beyond codeword_bits (interleave only moves
        # codeword_bits bits)
        il = np.asarray(c.interleave(cw))
        back = np.asarray(c.deinterleave(il))
        from libpoporon_jax.utils import bits as bitutils
        np.testing.assert_array_equal(
            bitutils.unpack_np(back, c.codeword_bits),
            bitutils.unpack_np(cw, c.codeword_bits),
        )

    def test_burst_resistance_comparison(self):
        """Burst-resistant preset corrects a burst the default may not
        (spirit of test_ldpc.c:447-507)."""
        from libpoporon_jax.config import ldpc_config_burst_resistant
        cfg = ldpc_config_burst_resistant(128, LdpcRate.RATE_1_2)
        import libpoporon_jax as pp
        codec_b = pp.create(cfg)
        rng = np.random.default_rng(6)
        data = rng.integers(0, 256, (4, 128), dtype=np.uint8)
        enc = codec_b.encode(data)
        d, p = np.asarray(enc.data), np.asarray(enc.parity)
        # burst: 4 consecutive bytes destroyed in the transmitted data
        bad = d.copy()
        bad[:, 40:44] ^= 0xFF
        res = codec_b.decode(bad, p)
        assert np.asarray(res.ok).all()
        # decode returns the ORIGINAL (outer-deinterleaved) data, not the
        # interleaved form the encoder leaves in the caller's buffer
        np.testing.assert_array_equal(np.asarray(res.data), data)


class TestAdaptive:
    def test_adaptive_matches_plain(self):
        c = codec(block=64)
        rng = np.random.default_rng(77)
        info = rng.integers(0, 256, (32, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        bad = cw.copy()
        # mixture: clean, light, heavy (non-converging) corruption
        for b in range(32):
            nf = [0, 1, 3, 40][b % 4]
            for p in rng.choice(c.codeword_bits, nf, replace=False):
                bad[b, p // 8] ^= 1 << (7 - (p % 8))
        ok1, out1, it1 = map(np.asarray, c.decode_hard(bad))
        ok2, out2, it2 = map(np.asarray, c.decode_hard_adaptive(bad))
        np.testing.assert_array_equal(ok1, ok2)
        np.testing.assert_array_equal(out1, out2)
        np.testing.assert_array_equal(it1, it2)

    def test_adaptive_chunked_matches_plain(self):
        """Batch larger than DECODE_CHUNK (with a ragged tail) goes
        through the pipelined chunk dispatch — results must stay
        bit-identical to one plain full-budget decode."""
        c = codec(block=64)
        old = c.DECODE_CHUNK
        c.DECODE_CHUNK = 16
        try:
            rng = np.random.default_rng(79)
            B = 53  # 3 full chunks + ragged tail of 5
            info = rng.integers(0, 256, (B, c.info_bytes), dtype=np.uint8)
            parity = np.asarray(c.encode(info))
            cw = np.concatenate([info, parity], axis=1)
            bad = cw.copy()
            for b in range(B):
                nf = [0, 1, 3, 40][b % 4]
                for p in rng.choice(c.codeword_bits, nf, replace=False):
                    bad[b, p // 8] ^= 1 << (7 - (p % 8))
            ok1, out1, it1 = map(np.asarray, c.decode_hard(bad))
            ok2, out2, it2 = map(np.asarray, c.decode_hard_adaptive(bad))
            np.testing.assert_array_equal(ok1, ok2)
            np.testing.assert_array_equal(out1, out2)
            np.testing.assert_array_equal(it1, it2)
        finally:
            c.DECODE_CHUNK = old

    def test_plain_ragged_chunked_matches_unchunked(self):
        """A plain decode_hard/decode_soft call with B % chunk != 0 must
        pad to a chunk multiple (keeping the fast-gather chunking) and
        return results bit-identical to a fully unchunked decode."""
        from libpoporon_jax.utils import bits as bitutils
        c = codec(block=64)
        rng = np.random.default_rng(81)
        B = 53  # chunk=16 -> pad to 64, 4 chunks
        info = rng.integers(0, 256, (B, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        bad = cw.copy()
        for b in range(B):
            nf = [0, 1, 3, 40][b % 4]
            for p in rng.choice(c.codeword_bits, nf, replace=False):
                bad[b, p // 8] ^= 1 << (7 - (p % 8))
        cb = bitutils.unpack_np(bad, c.codeword_bits)
        llr = np.where(cb == 1, -100, 100).astype(np.int8)
        old = c.DECODE_CHUNK
        try:
            c.DECODE_CHUNK = 1 << 30  # unchunked ground truth
            ref_h = [np.asarray(x) for x in c.decode_hard(bad)]
            ref_s = [np.asarray(x) for x in c.decode_soft(llr)]
            c.DECODE_CHUNK = 16
            got_h = [np.asarray(x) for x in c.decode_hard(bad)]
            got_s = [np.asarray(x) for x in c.decode_soft(llr)]
        finally:
            c.DECODE_CHUNK = old
        for r, g in zip(ref_h + ref_s, got_h + got_s):
            assert r.shape[0] == B and g.shape[0] == B
            np.testing.assert_array_equal(r, g)

    def test_adaptive_soft_matches_plain(self):
        from libpoporon_jax.utils import bits as bitutils
        c = codec(block=64)
        rng = np.random.default_rng(78)
        info = rng.integers(0, 256, (16, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        cb = bitutils.unpack_np(cw, c.codeword_bits)
        llr = np.where(cb == 1, -100, 100).astype(np.int8)
        for b in range(16):
            nf = [0, 2, 6, 60][b % 4]
            pos = rng.choice(c.codeword_bits, nf, replace=False)
            llr[b, pos] = -llr[b, pos]
        ok1, out1, it1 = map(np.asarray, c.decode_soft(llr))
        ok2, out2, it2 = map(np.asarray, c.decode_soft_adaptive(llr))
        np.testing.assert_array_equal(ok1, ok2)
        np.testing.assert_array_equal(out1, out2)
        np.testing.assert_array_equal(it1, it2)


class TestBigBlocks:
    def test_max_block_rate_13_roundtrip(self):
        """8192-byte blocks, rate 1/3 — the gather (non-dense-H) path."""
        c = codec(block=8192, rate=LdpcRate.RATE_1_3)
        assert c.H_dense is None  # falls back to edge gathers
        rng = np.random.default_rng(0)
        info = rng.integers(0, 256, (2, c.info_bytes), dtype=np.uint8)
        par = np.asarray(c.encode(info))
        cw = np.concatenate([info, par], axis=1)
        assert np.asarray(c.check(cw)).all()
        bad = cw.copy()
        bad[:, 100] ^= 0x10
        bad[:, 5000] ^= 0x02
        ok, out, iters = map(np.asarray, c.decode_hard(bad))
        assert ok.all()
        np.testing.assert_array_equal(out, cw)


class TestSoftBER:
    def test_awgn_1e2_ber_decode(self):
        """BASELINE config #5: soft LLR decode at ~1e-2 channel BER."""
        from libpoporon_jax.utils import bits as bitutils
        from libpoporon_jax.utils.faults import awgn_llrs
        c = codec(block=128)
        rng = np.random.default_rng(9)
        B = 16
        info = rng.integers(0, 256, (B, c.info_bytes), dtype=np.uint8)
        par = np.asarray(c.encode(info))
        cw = np.concatenate([info, par], axis=1)
        cb = bitutils.unpack_np(cw, c.codeword_bits)
        llr = awgn_llrs(cb, snr_db=4.3, rng=10)
        raw_ber = ((llr < 0).astype(np.uint8) != cb).mean()
        assert 0.002 < raw_ber < 0.05  # ~1e-2 regime
        ok, out, iters = map(np.asarray, c.decode_soft(llr))
        # BP at this SNR should fix the overwhelming majority
        assert ok.mean() >= 0.8
        decoded_bits = bitutils.unpack_np(out[ok], c.codeword_bits)
        np.testing.assert_array_equal(decoded_bits, cb[ok])
