"""Golden bit-exactness suite: every codec vs the compiled reference C
library on shared random vectors (the analogue of tests/fec_compat.c).
"""

import numpy as np
import pytest

import oracle

pytestmark = pytest.mark.skipif(
    not oracle.available(), reason="reference oracle unavailable"
)

import libpoporon_jax as pp
from libpoporon_jax.models.ldpc import get_structure
from libpoporon_jax.config import LdpcConfig, LdpcMatrixType, LdpcRate


# ===================================================================== RS

class TestRS:
    @pytest.mark.parametrize("size", [223, 200, 100, 32, 1])
    def test_encode_default(self, size):
        rng = np.random.default_rng(size)
        data = rng.integers(0, 256, (8, size), dtype=np.uint8)
        codec = pp.create(pp.rs_config_default())
        ours = np.asarray(codec.encode(data).parity)
        ref = oracle.RS()
        for b in range(8):
            np.testing.assert_array_equal(ours[b], ref.encode(data[b]))
        ref.close()

    @pytest.mark.parametrize(
        "params",
        [
            dict(symbol_size=8, poly=0x11D, fcr=1, prim=1, num_roots=16),
            dict(symbol_size=8, poly=0x11D, fcr=0, prim=1, num_roots=8),
            dict(symbol_size=8, poly=0x11D, fcr=2, prim=2, num_roots=32),
            dict(symbol_size=4, poly=0x13, fcr=1, prim=1, num_roots=4),
            dict(symbol_size=5, poly=0x25, fcr=1, prim=1, num_roots=6),
        ],
    )
    def test_encode_variants(self, params):
        fs = (1 << params["symbol_size"]) - 1
        size = fs - params["num_roots"]
        rng = np.random.default_rng(fs)
        data = rng.integers(0, 256, (4, size), dtype=np.uint8)
        cfg = pp.RSConfig(
            params["symbol_size"], params["poly"], params["fcr"],
            params["prim"], params["num_roots"],
        )
        codec = pp.create(cfg)
        ours = np.asarray(codec.encode(data).parity)
        ref = oracle.RS(params["symbol_size"], params["poly"], params["fcr"],
                        params["prim"], params["num_roots"])
        for b in range(4):
            np.testing.assert_array_equal(ours[b], ref.encode(data[b]))
        ref.close()

    @pytest.mark.parametrize("nerr", [0, 1, 2, 8, 16, 17, 30])
    def test_decode_errors(self, nerr):
        B, size = 6, 223
        rng = np.random.default_rng(nerr + 100)
        data = rng.integers(0, 256, (B, size), dtype=np.uint8)
        codec = pp.create(pp.rs_config_default())
        parity = np.asarray(codec.encode(data).parity)

        corrupt = data.copy()
        for b in range(B):
            pos = rng.choice(size, nerr, replace=False)
            for p in pos:
                corrupt[b, p] ^= rng.integers(1, 256)

        ok, d, p, corr = codec.decode(corrupt, parity)
        ok, d, p, corr = map(np.asarray, (ok, d, p, corr))
        ref = oracle.RS()
        for b in range(B):
            rok, rd, rp, rc = ref.decode(corrupt[b], parity[b])
            assert bool(ok[b]) == rok, f"b={b} ok mismatch"
            np.testing.assert_array_equal(d[b], rd)
            np.testing.assert_array_equal(p[b], rp)
            assert int(corr[b]) == rc
        ref.close()

    @pytest.mark.parametrize("size", [223, 150, 64])
    def test_decode_parity_errors_and_shortened(self, size):
        """Errors in the parity section + shortened codes."""
        B = 4
        rng = np.random.default_rng(size)
        data = rng.integers(0, 256, (B, size), dtype=np.uint8)
        codec = pp.create(pp.rs_config_default())
        parity = np.asarray(codec.encode(data).parity)
        bad_parity = parity.copy()
        for b in range(B):
            pos = rng.choice(32, 5, replace=False)
            for p in pos:
                bad_parity[b, p] ^= rng.integers(1, 256)
        ok, d, p, corr = map(np.asarray, codec.decode(data, bad_parity))
        ref = oracle.RS()
        for b in range(B):
            rok, rd, rp, rc = ref.decode(data[b], bad_parity[b])
            assert bool(ok[b]) == rok
            np.testing.assert_array_equal(d[b], rd)
            np.testing.assert_array_equal(p[b], rp)
            assert int(corr[b]) == rc
        ref.close()

    def test_decode_random_junk(self):
        B, size = 16, 223
        rng = np.random.default_rng(7)
        data = rng.integers(0, 256, (B, size), dtype=np.uint8)
        parity = rng.integers(0, 256, (B, 32), dtype=np.uint8)
        codec = pp.create(pp.rs_config_default())
        ok, d, p, corr = map(np.asarray, codec.decode(data, parity))
        ref = oracle.RS()
        for b in range(B):
            rok, rd, rp, rc = ref.decode(data[b], parity[b])
            assert bool(ok[b]) == rok, f"b={b}"
            np.testing.assert_array_equal(d[b], rd)
            np.testing.assert_array_equal(p[b], rp)
            assert int(corr[b]) == rc
        ref.close()

    @pytest.mark.parametrize("ne", [4, 16, 32])
    def test_erasure_decode(self, ne):
        """Erasure decoding with known positions (test_codec.c:123-168)."""
        B, size = 4, 223
        rng = np.random.default_rng(ne)
        data = rng.integers(0, 256, (B, size), dtype=np.uint8)
        codec = pp.create(pp.rs_config_default())
        parity = np.asarray(codec.encode(data).parity)
        pos = np.sort(rng.choice(size, ne, replace=False)).astype(np.uint32)
        corrupt = data.copy()
        for b in range(B):
            for p in pos:
                corrupt[b, p] ^= 0xFF
        ok, d, p, corr = map(
            np.asarray, codec.decode(corrupt, parity, erasures=pos.astype(np.int32))
        )
        ref = oracle.RS(erasure_positions=pos)
        for b in range(B):
            rok, rd, rp, rc = ref.decode(corrupt[b], parity[b])
            assert bool(ok[b]) == rok, f"b={b}"
            np.testing.assert_array_equal(d[b], rd)
            assert int(corr[b]) == rc
        ref.close()

    def test_external_syndrome_no_errors(self):
        """All-sentinel external syndromes = "no errors" (test_codec.c:78-121)."""
        B, size = 2, 223
        rng = np.random.default_rng(3)
        data = rng.integers(0, 256, (B, size), dtype=np.uint8)
        codec = pp.create(pp.rs_config_default())
        parity = np.asarray(codec.encode(data).parity)
        synd = np.full(32, 255, dtype=np.uint16)  # sentinel = fs
        ok, d, p, corr = map(
            np.asarray, codec.decode(data, parity, ext_syndrome=synd.astype(np.int32))
        )
        ref = oracle.RS(ext_syndrome=synd)
        for b in range(B):
            rok, rd, rp, rc = ref.decode(data[b], parity[b])
            assert bool(ok[b]) == rok
            np.testing.assert_array_equal(d[b], rd)
            assert int(corr[b]) == rc
        ref.close()

    def test_fec_compat_config_nroots127(self):
        """The fec_compat.c config (tests/fec_compat.c:20-27):
        RS(255,128) with 127 roots, correcting 63 errors — and the
        constructor must be fast (a round-2 finding: the Python-LFSR
        matrix build plus an unrolled omega convolution made this
        config take minutes to construct + compile)."""
        import time

        t0 = time.perf_counter()
        codec = pp.create(pp.RSConfig(8, 0x11D, 1, 1, 127))
        dt = time.perf_counter() - t0
        assert dt < 5.0, f"RS nroots=127 construction took {dt:.1f}s"

        rng = np.random.default_rng(127)
        size = 128
        data = rng.integers(0, 256, (4, size), dtype=np.uint8)
        parity = np.asarray(codec.encode(data).parity)
        ref = oracle.RS(num_roots=127)
        for b in range(4):
            np.testing.assert_array_equal(parity[b], ref.encode(data[b]))
        # corrupt t = 63 symbols per codeword (fec_compat.c:131-145 sweep
        # intent), decode, compare byte-exact against the oracle
        bad = data.copy()
        for b in range(4):
            pos = rng.choice(size, size=63, replace=False)
            bad[b, pos] ^= rng.integers(1, 256, 63, dtype=np.uint8)
        ok, d, p, corr = map(np.asarray, codec.decode(bad, parity))
        for b in range(4):
            rok, rd, rp, rc = ref.decode(bad[b], parity[b])
            assert bool(ok[b]) == rok
            np.testing.assert_array_equal(d[b], rd)
            np.testing.assert_array_equal(p[b], rp)
            assert int(corr[b]) == rc
        assert ok.all() and (d == data).all() and (corr == 63).all()
        # 64 errors (t+1) must fail bit-identically too
        bad64 = data.copy()
        for b in range(4):
            pos = rng.choice(size, size=64, replace=False)
            bad64[b, pos] ^= rng.integers(1, 256, 64, dtype=np.uint8)
        ok, d, p, corr = map(np.asarray, codec.decode(bad64, parity))
        for b in range(4):
            rok, rd, rp, rc = ref.decode(bad64[b], parity[b])
            assert bool(ok[b]) == rok
            np.testing.assert_array_equal(d[b], rd)
            assert int(corr[b]) == rc
        ref.close()

    def test_invalid_size_rejected(self):
        codec = pp.create(pp.rs_config_default())
        data = np.zeros((2, 224), dtype=np.uint8)  # > k = 223
        parity = np.zeros((2, 32), dtype=np.uint8)
        ok, d, p, corr = codec.decode(data, parity)
        assert not bool(np.asarray(ok).any())


# ==================================================================== BCH

class TestBCH:
    def test_bch15_exhaustive_encode(self):
        """All 32 datawords (test_bch.c:95-158)."""
        codec = pp.create(pp.bch_config_default())
        ref = oracle.BCH()
        b = codec._bch
        data = np.arange(32, dtype=np.int64)
        ok, cw = b.encode(data)
        cw = np.asarray(cw)
        for d in range(32):
            rok, rcw = ref.encode(d)
            assert rok and int(cw[d]) == rcw
        ref.close()

    def test_bch15_all_single_double_errors(self):
        codec = pp.create(pp.bch_config_default())
        b = codec._bch
        ref = oracle.BCH()
        words = []
        for d in range(32):
            _, cw = ref.encode(d)
            words.append(cw)
        received = []
        for cw in words:
            for i in range(15):
                received.append(cw ^ (1 << i))
                for j in range(i + 1, 15):
                    received.append(cw ^ (1 << i) ^ (1 << j))
        received = np.array(received, dtype=np.int64)
        ok, corr, ne = map(np.asarray, b.decode(received))
        for i, r in enumerate(received):
            rok, rcw, rne = ref.decode(int(r))
            assert bool(ok[i]) == rok, f"word {i}"
            assert int(corr[i]) == rcw
            assert int(ne[i]) == rne
        ref.close()

    def test_bch15_triple_and_overload(self):
        codec = pp.create(pp.bch_config_default())
        b = codec._bch
        ref = oracle.BCH()
        rng = np.random.default_rng(5)
        received = []
        for _ in range(300):
            _, cw = ref.encode(int(rng.integers(0, 32)))
            nerr = int(rng.integers(3, 6))
            pos = rng.choice(15, nerr, replace=False)
            for p in pos:
                cw ^= 1 << int(p)
            received.append(cw)
        received = np.array(received, dtype=np.int64)
        ok, corr, ne = map(np.asarray, b.decode(received))
        for i, r in enumerate(received):
            rok, rcw, rne = ref.decode(int(r))
            assert bool(ok[i]) == rok, f"i={i}"
            assert int(corr[i]) == rcw
            assert int(ne[i]) == rne
        ref.close()

    def test_bch31(self):
        cfg = pp.BchConfig(5, 0x25, 2)
        codec = pp.create(cfg)
        b = codec._bch
        ref = oracle.BCH(5, 0x25, 2)
        assert b.n == ref.codeword_length
        assert b.data_length == ref.data_length
        rng = np.random.default_rng(11)
        datas = rng.integers(0, 1 << b.data_length, 64, dtype=np.int64)
        ok, cw = map(np.asarray, b.encode(datas))
        for i, d in enumerate(datas):
            rok, rcw = ref.encode(int(d))
            assert int(cw[i]) == rcw
        # errors
        received = cw.copy()
        for i in range(64):
            nerr = int(rng.integers(0, 4))
            pos = rng.choice(31, nerr, replace=False)
            for p in pos:
                received[i] ^= 1 << int(p)
        ok, corr, ne = map(np.asarray, b.decode(received))
        for i, r in enumerate(received):
            rok, rcw, rne = ref.decode(int(r))
            assert bool(ok[i]) == rok, f"i={i}"
            assert int(corr[i]) == rcw
            assert int(ne[i]) == rne
        ref.close()

    def test_facade_bytes_bch31_multibyte(self):
        """BCH(31,21) byte path: 3 data bytes / 2 parity bytes exercises
        the multi-byte big-endian pack (decode.c:559-575), which the
        BCH(15,5) test (1 data byte) cannot."""
        cfg = pp.BchConfig(5, 0x25, 2)
        codec = pp.create(cfg)
        ref = oracle.BCHFacade(5, 0x25, 2)
        assert codec.parity_size == ref.parity_size == 2
        assert codec.info_size == ref.info_size == 3
        rng = np.random.default_rng(23)
        data = rng.integers(0, 256, (32, 3), dtype=np.uint8)
        parity = np.asarray(codec.encode(data).parity)
        for b in range(32):
            np.testing.assert_array_equal(parity[b], ref.encode(data[b]))
        # flip 2 bits across different bytes and decode
        corrupt = data.copy()
        corrupt[:, 1] ^= 0x10
        corrupt[:, 2] ^= 0x02
        ok, d, p, corr = map(np.asarray, codec.decode(corrupt, parity))
        for b in range(32):
            rok, rd, rp, rc = ref.decode(corrupt[b], parity[b])
            assert bool(ok[b]) == rok
            np.testing.assert_array_equal(d[b], rd)
            assert int(corr[b]) == rc
        ref.close()

    def test_facade_bytes(self):
        codec = pp.create(pp.bch_config_default())
        ref = oracle.BCHFacade()
        assert codec.parity_size == ref.parity_size
        assert codec.info_size == ref.info_size
        rng = np.random.default_rng(1)
        data = rng.integers(0, 32, (16, 1), dtype=np.uint8)
        parity = np.asarray(codec.encode(data).parity)
        for b in range(16):
            np.testing.assert_array_equal(parity[b], ref.encode(data[b]))
        # flip bits and decode
        corrupt = data ^ np.uint8(0x04)
        ok, d, p, corr = map(np.asarray, codec.decode(corrupt, parity))
        for b in range(16):
            rok, rd, rp, rc = ref.decode(corrupt[b], parity[b])
            assert bool(ok[b]) == rok
            np.testing.assert_array_equal(d[b], rd)
            assert int(corr[b]) == rc
        ref.close()


# =================================================================== LDPC

LDPC_CONFIGS = [
    dict(block_size=32, rate=1, column_weight=3),
    dict(block_size=128, rate=1, column_weight=3),
    dict(block_size=64, rate=0, column_weight=3),
    dict(block_size=120, rate=2, column_weight=4),
    dict(block_size=256, rate=5, column_weight=7),
    dict(block_size=32, rate=1, column_weight=3, seed=42),
]


def _mk(block_size, rate, column_weight=3, matrix_type=1, inner=False,
        outer=False, depth=0, lifting=0, seed=0):
    return LdpcConfig(
        block_size=block_size, rate=LdpcRate(rate),
        matrix_type=LdpcMatrixType(matrix_type), column_weight=column_weight,
        use_inner_interleave=inner, use_outer_interleave=outer,
        interleave_depth=depth, lifting_factor=lifting, seed=seed,
    )


class TestLDPCStructure:
    @pytest.mark.parametrize("cfgkw", LDPC_CONFIGS)
    def test_matrix_bit_exact(self, cfgkw):
        cfg = _mk(**{k: v for k, v in cfgkw.items()})
        s = get_structure(cfg)
        ref = oracle.LDPC(
            cfgkw["block_size"], cfgkw["rate"],
            column_weight=cfgkw.get("column_weight", 3),
            seed=cfgkw.get("seed", 0),
        )
        st = ref.structure()
        np.testing.assert_array_equal(s.row_ptr, st["row_ptr"])
        np.testing.assert_array_equal(s.col_idx, st["col_idx"][: len(s.col_idx)])
        assert s.num_edges_alloc == st["num_edges"]
        ref.close()

    @pytest.mark.parametrize("block,rate", [(32, 1), (128, 1), (64, 3)])
    def test_qc_matrix_bit_exact(self, block, rate):
        cfg = _mk(block, rate, matrix_type=2)
        s = get_structure(cfg)
        ref = oracle.LDPC(block, rate, matrix_type=2)
        st = ref.structure()
        np.testing.assert_array_equal(s.row_ptr, st["row_ptr"])
        np.testing.assert_array_equal(s.col_idx, st["col_idx"][: len(s.col_idx)])
        ref.close()

    @pytest.mark.parametrize("block,rate,seed", [(32, 1, 0), (128, 1, 7), (96, 2, 3)])
    def test_interleavers_bit_exact(self, block, rate, seed):
        cfg = _mk(block, rate, inner=True, outer=True, seed=seed)
        s = get_structure(cfg)
        ref = oracle.LDPC(block, rate, inner=True, outer=True, seed=seed)
        il = ref.interleavers()
        np.testing.assert_array_equal(s.inner_forward, il["inner_forward"])
        assert s.inner_depth == il["inner_depth"]
        np.testing.assert_array_equal(s.outer_forward, il["outer_forward"])
        ref.close()


class TestLDPCCodec:
    @pytest.mark.parametrize("cfgkw", LDPC_CONFIGS[:4])
    def test_encode_bit_exact(self, cfgkw):
        cfg = _mk(**cfgkw)
        from libpoporon_jax.models.ldpc import LDPCCodec
        c = LDPCCodec(cfg)
        ref = oracle.LDPC(
            cfgkw["block_size"], cfgkw["rate"],
            column_weight=cfgkw.get("column_weight", 3),
            seed=cfgkw.get("seed", 0),
        )
        rng = np.random.default_rng(99)
        info = rng.integers(0, 256, (4, c.info_bytes), dtype=np.uint8)
        ours = np.asarray(c.encode(info))
        for b in range(4):
            np.testing.assert_array_equal(ours[b], ref.encode(info[b]))
        ref.close()

    @pytest.mark.parametrize("nflip", [0, 1, 3, 8])
    def test_decode_hard_bit_exact(self, nflip):
        cfg = _mk(128, 1)
        from libpoporon_jax.models.ldpc import LDPCCodec
        c = LDPCCodec(cfg)
        ref = oracle.LDPC(128, 1)
        rng = np.random.default_rng(nflip + 1)
        B = 4
        info = rng.integers(0, 256, (B, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        for b in range(B):
            pos = rng.choice(c.codeword_bits, nflip, replace=False)
            for p in pos:
                cw[b, p // 8] ^= 1 << (7 - (p % 8))
        ok, out, iters = map(np.asarray, c.decode_hard(cw))
        for b in range(B):
            rok, rcw, rit = ref.decode_hard(cw[b])
            assert bool(ok[b]) == rok, f"b={b}"
            np.testing.assert_array_equal(out[b], rcw)
            assert int(iters[b]) == rit, f"b={b}"
        ref.close()

    def test_decode_big_block_bit_exact(self):
        """1024B rate-1/2 exercises the fused-syndrome big-code driver
        (_bp_loop_big: H_dense is None above ~512B): hard + soft,
        exact outputs AND iteration counts vs the reference."""
        cfg = _mk(1024, 1)
        from libpoporon_jax.models.ldpc import LDPCCodec
        c = LDPCCodec(cfg)
        assert c.H_dense is None  # the big-code driver must be in play
        ref = oracle.LDPC(1024, 1)
        rng = np.random.default_rng(77)
        B = 3
        info = rng.integers(0, 256, (B, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        for b in range(B):
            pos = rng.choice(c.codeword_bits, 6 * b, replace=False)
            for p in pos:
                cw[b, p // 8] ^= 1 << (7 - (p % 8))
        ok, out, iters = map(np.asarray, c.decode_hard(cw))
        for b in range(B):
            rok, rcw, rit = ref.decode_hard(cw[b])
            assert bool(ok[b]) == rok, f"b={b}"
            np.testing.assert_array_equal(out[b], rcw)
            assert int(iters[b]) == rit, f"b={b}"
        # soft: true channel LLRs with enough noise to need iterations
        from libpoporon_jax.utils import bits as bitutils
        cb = bitutils.unpack_np(cw, c.codeword_bits)
        clean = np.where(cb == 1, -90.0, 90.0)
        noisy = clean + rng.normal(0, 35.0, clean.shape)
        llr = np.clip(np.round(noisy), -127, 127).astype(np.int8)
        ok, out, iters = map(np.asarray, c.decode_soft(llr))
        for b in range(B):
            rok, rcw, rit = ref.decode_soft(llr[b])
            assert bool(ok[b]) == rok, f"b={b}"
            np.testing.assert_array_equal(out[b], rcw)
            assert int(iters[b]) == rit, f"b={b}"
        ref.close()

    def test_decode_hard_heavy_noise(self):
        """Non-converging inputs: best-effort output must match too."""
        cfg = _mk(32, 1)
        from libpoporon_jax.models.ldpc import LDPCCodec
        c = LDPCCodec(cfg)
        ref = oracle.LDPC(32, 1)
        rng = np.random.default_rng(0)
        cw = rng.integers(0, 256, (4, c.codeword_bytes), dtype=np.uint8)
        ok, out, iters = map(np.asarray, c.decode_hard(cw))
        for b in range(4):
            rok, rcw, rit = ref.decode_hard(cw[b])
            assert bool(ok[b]) == rok
            np.testing.assert_array_equal(out[b], rcw)
            assert int(iters[b]) == rit
        ref.close()

    @pytest.mark.parametrize("nflip", [0, 3, 10])
    def test_decode_soft_bit_exact(self, nflip):
        cfg = _mk(64, 1)
        from libpoporon_jax.models.ldpc import LDPCCodec
        c = LDPCCodec(cfg)
        ref = oracle.LDPC(64, 1)
        rng = np.random.default_rng(nflip + 21)
        B = 4
        info = rng.integers(0, 256, (B, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        import libpoporon_jax.utils.bits as bits
        cb = bits.unpack_np(cw, c.codeword_bits)
        llr = np.where(cb == 1, -100, 100).astype(np.int8)
        for b in range(B):
            pos = rng.choice(c.codeword_bits, nflip, replace=False)
            llr[b, pos] = -llr[b, pos]
        # add mild noise
        llr = (llr + rng.integers(-20, 21, llr.shape)).clip(-127, 127).astype(np.int8)
        ok, out, iters = map(np.asarray, c.decode_soft(llr))
        for b in range(B):
            rok, rcw, rit = ref.decode_soft(llr[b])
            assert bool(ok[b]) == rok, f"b={b}"
            np.testing.assert_array_equal(out[b], rcw)
            assert int(iters[b]) == rit
        ref.close()

    def test_decode_soft_with_inner_interleave(self):
        """Soft decode + inner interleave: exercises the LLR
        deinterleave path (ldpc.c:1043-1049), which the hard+inner test
        cannot reach."""
        cfg = _mk(64, 1, inner=True)
        from libpoporon_jax.models.ldpc import LDPCCodec
        import libpoporon_jax.utils.bits as bits
        c = LDPCCodec(cfg)
        ref = oracle.LDPC(64, 1, inner=True)
        rng = np.random.default_rng(12)
        B = 4
        info = rng.integers(0, 256, (B, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        # interleave (as the facade's encode would), then derive LLRs of
        # the transmitted (interleaved) bits and flip a few
        cwi = np.asarray(c.interleave(cw))
        cb = bits.unpack_np(cwi, c.codeword_bits)
        llr = np.where(cb == 1, -90, 90).astype(np.int8)
        for b in range(B):
            pos = rng.choice(c.codeword_bits, 5, replace=False)
            llr[b, pos] = -llr[b, pos]
        llr = (llr + rng.integers(-15, 16, llr.shape)).clip(-127, 127).astype(np.int8)
        ok, out, iters = map(np.asarray, c.decode_soft(llr))
        for b in range(B):
            rok, rcw, rit = ref.decode_soft(llr[b])
            assert bool(ok[b]) == rok, f"b={b}"
            np.testing.assert_array_equal(out[b], rcw)
            assert int(iters[b]) == rit, f"b={b}"
        ref.close()

    def test_adaptive_cascade_at_trigger_size(self):
        """Adaptive cascade vs oracle at its real facade trigger size
        (B >= 512, facade.py) with mixed convergence behavior — covers
        straggler compaction, redundant-slot writes, and best-effort
        non-convergence outputs at scale."""
        cfg = _mk(32, 1)
        from libpoporon_jax.models.ldpc import LDPCCodec
        c = LDPCCodec(cfg)
        ref = oracle.LDPC(32, 1)
        rng = np.random.default_rng(77)
        B = 512
        info = rng.integers(0, 256, (B, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        cw = np.concatenate([info, parity], axis=1)
        # mixed error weights: 0 flips (pre-converged), light (stage-1
        # converging), heavy (stragglers), random junk (non-converging)
        for b in range(B):
            kind = b % 4
            if kind == 0:
                continue
            if kind == 1:
                nflip = int(rng.integers(1, 4))
            elif kind == 2:
                nflip = int(rng.integers(8, 16))
            else:
                cw[b] = rng.integers(0, 256, c.codeword_bytes, dtype=np.uint8)
                continue
            for p in rng.choice(c.codeword_bits, nflip, replace=False):
                cw[b, p // 8] ^= 1 << (7 - (p % 8))
        ok, out, iters = map(np.asarray, c.decode_hard_adaptive(cw))
        for b in range(B):
            rok, rcw, rit = ref.decode_hard(cw[b])
            assert bool(ok[b]) == rok, f"b={b}"
            np.testing.assert_array_equal(out[b], rcw, err_msg=f"b={b}")
            assert int(iters[b]) == rit, f"b={b}"
        ref.close()

    def test_decode_hard_with_inner_interleave(self):
        cfg = _mk(64, 1, inner=True)
        from libpoporon_jax.models.ldpc import LDPCCodec
        c = LDPCCodec(cfg)
        ref = oracle.LDPC(64, 1, inner=True)
        rng = np.random.default_rng(8)
        cw = rng.integers(0, 256, (2, c.codeword_bytes), dtype=np.uint8)
        ok, out, iters = map(np.asarray, c.decode_hard(cw))
        for b in range(2):
            rok, rcw, rit = ref.decode_hard(cw[b])
            assert bool(ok[b]) == rok
            np.testing.assert_array_equal(out[b], rcw)
            assert int(iters[b]) == rit
        ref.close()


class TestLDPCFacade:
    @pytest.mark.parametrize(
        "kw",
        [
            dict(),
            dict(outer=True),
            dict(inner=True),
            dict(inner=True, outer=True),
        ],
    )
    def test_facade_roundtrip_bit_exact(self, kw):
        block, rate = 64, 1
        cfg = LdpcConfig(
            block_size=block, rate=LdpcRate(rate),
            use_inner_interleave=kw.get("inner", False),
            use_outer_interleave=kw.get("outer", False),
        )
        codec = pp.create(cfg)
        ref = oracle.LDPCFacade(
            block, rate, inner=kw.get("inner", False), outer=kw.get("outer", False)
        )
        assert codec.parity_size == ref.parity_size
        assert codec.info_size == ref.info_size
        rng = np.random.default_rng(17)
        B = 3
        data = rng.integers(0, 256, (B, block), dtype=np.uint8)
        enc = codec.encode(data)
        d_ours, p_ours = np.asarray(enc.data), np.asarray(enc.parity)
        refs = [ref.encode(data[b]) for b in range(B)]
        for b in range(B):
            np.testing.assert_array_equal(d_ours[b], refs[b][0])
            np.testing.assert_array_equal(p_ours[b], refs[b][1])
        # corrupt a couple of bits and decode
        dcor = d_ours.copy()
        for b in range(B):
            dcor[b, rng.integers(0, block)] ^= 0x10
        res = codec.decode(dcor, p_ours)
        ok, dd, pdd, corr = map(np.asarray, res)
        for b in range(B):
            rok, rd, rp, rc, rit = ref.decode(dcor[b], p_ours[b])
            assert bool(ok[b]) == rok, f"b={b}"
            np.testing.assert_array_equal(dd[b], rd)
            assert int(corr[b]) == rc
        ref.close()


class TestMoreCoverage:
    def test_qc_ldpc_decode_bit_exact(self):
        cfg = _mk(64, 1, matrix_type=2)
        from libpoporon_jax.models.ldpc import LDPCCodec
        c = LDPCCodec(cfg)
        ref = oracle.LDPC(64, 1, matrix_type=2)
        rng = np.random.default_rng(31)
        info = rng.integers(0, 256, (4, c.info_bytes), dtype=np.uint8)
        parity = np.asarray(c.encode(info))
        for b in range(4):
            np.testing.assert_array_equal(parity[b], ref.encode(info[b]))
        cw = np.concatenate([info, parity], axis=1)
        for b in range(4):
            for p in rng.choice(c.codeword_bits, 2, replace=False):
                cw[b, p // 8] ^= 1 << (7 - (p % 8))
        ok, out, iters = map(np.asarray, c.decode_hard(cw))
        for b in range(4):
            rok, rcw, rit = ref.decode_hard(cw[b])
            assert bool(ok[b]) == rok
            np.testing.assert_array_equal(out[b], rcw)
            assert int(iters[b]) == rit
        ref.close()

    def test_facade_soft_llr_bit_exact(self):
        """Facade soft path with bound LLRs vs the reference config-bound
        soft_llr (decode.c:509-511)."""
        import libpoporon_jax.utils.bits as bits
        block, rate = 64, 1
        cfg = LdpcConfig(block_size=block, rate=LdpcRate(rate),
                         use_soft_decode=True)
        codec = pp.create(cfg)
        from libpoporon_jax.models.ldpc import LDPCCodec
        c = codec._ldpc
        rng = np.random.default_rng(5)
        data = rng.integers(0, 256, (2, block), dtype=np.uint8)
        enc = codec.encode(data)
        d, p = np.asarray(enc.data), np.asarray(enc.parity)
        cw = np.concatenate([d, p], axis=1)
        cb = bits.unpack_np(cw, c.codeword_bits)
        llr = np.where(cb == 1, -80, 80).astype(np.int8)
        for b in range(2):
            pos = rng.choice(c.codeword_bits, 4, replace=False)
            llr[b, pos] = -llr[b, pos]
        res = codec.decode(d, p, soft_llr=llr)
        ok, dd = np.asarray(res.ok), np.asarray(res.data)
        for b in range(2):
            ref = oracle.LDPCFacade(block, rate, use_soft=True, soft_llr=llr[b])
            rok, rd, rp, rc, rit = ref.decode(d[b], p[b])
            assert bool(ok[b]) == rok
            np.testing.assert_array_equal(dd[b], rd)
            assert int(np.asarray(res.corrected)[b]) == rc
            ref.close()

    @pytest.mark.parametrize("m,poly,nr", [(4, 0x13, 4), (5, 0x25, 6)])
    def test_small_field_rs_decode(self, m, poly, nr):
        fs = (1 << m) - 1
        size = fs - nr
        cfg = pp.RSConfig(m, poly, 1, 1, nr)
        codec = pp.create(cfg)
        rng = np.random.default_rng(m)
        data = rng.integers(0, 1 << m, (6, size), dtype=np.uint8)
        parity = np.asarray(codec.encode(data).parity)
        bad = data.copy()
        for b in range(6):
            pos = rng.choice(size, nr // 2, replace=False)
            for p0 in pos:
                bad[b, p0] ^= rng.integers(1, 1 << m)
        ok, d, p, corr = map(np.asarray, codec.decode(bad, parity))
        ref = oracle.RS(m, poly, 1, 1, nr)
        for b in range(6):
            rok, rd, rp, rc = ref.decode(bad[b], parity[b])
            assert bool(ok[b]) == rok, f"b={b}"
            np.testing.assert_array_equal(d[b], rd)
            np.testing.assert_array_equal(p[b], rp)
            assert int(corr[b]) == rc
        ref.close()

    def test_rs_mixed_erasures_and_errors(self):
        """Erasure decode with extra (unknown-position) errors on top."""
        codec = pp.create(pp.rs_config_default())
        rng = np.random.default_rng(3)
        B, size = 4, 223
        data = rng.integers(0, 256, (B, size), dtype=np.uint8)
        parity = np.asarray(codec.encode(data).parity)
        epos = np.sort(rng.choice(size, 10, replace=False)).astype(np.uint32)
        bad = data.copy()
        for b in range(B):
            for p0 in epos:
                bad[b, p0] ^= 0xFF
            # 3 extra random errors
            for p0 in rng.choice(size, 3, replace=False):
                bad[b, p0] ^= 0x55
        ok, d, p, corr = map(
            np.asarray, codec.decode(bad, parity, erasures=epos.astype(np.int32))
        )
        ref = oracle.RS(erasure_positions=epos)
        for b in range(B):
            rok, rd, rp, rc = ref.decode(bad[b], parity[b])
            # NOTE: when BM finds more errors than provided erasures, the
            # reference applies the extra corrections at UNINITIALIZED
            # positions (erasure.c allocates without zeroing; decode.c:212
            # indexes past erasure_count) — genuine UB, so only the
            # deterministic outputs (ok flag, corrected count, and data
            # at the known erasure positions) are compared.
            assert bool(ok[b]) == rok, f"b={b}"
            assert int(corr[b]) == rc
            np.testing.assert_array_equal(d[b][epos], rd[epos])
        ref.close()
