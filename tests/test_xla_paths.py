"""Decode paths at the shapes that matter for batching: mixed error
loads, erasure and external-syndrome decode, shortened codes, ragged
batches around the LDPC chunk width, budget exhaustion, and the
adaptive cascade against one full-budget decode.

Every case is checked against ground truth (the data that was encoded)
and, where the path has a cheaper or chunked variant, bit for bit
against the plain full-budget path.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import libpoporon_jax as pp
from libpoporon_jax.config import LdpcConfig, LdpcMatrixType, LdpcRate, RSConfig
from libpoporon_jax.models.ldpc import LDPCCodec
from libpoporon_jax.models.rs import RSCodec
from libpoporon_jax.utils import bits as bitutils

from chip_smoke import corrupt_symbols, flip_bits, host_syndromes_log

RS = RSCodec(RSConfig())


def _host(out):
    return tuple(np.asarray(x) for x in out)


def _assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ------------------------------------------------------------------ RS

def test_rs_plain_mixed_load():
    """Clean rows, 1..16 errors and junk rows in one batch: every row
    within t is restored (data, parity, count); junk rows fail."""
    rng = np.random.default_rng(11)
    B = 128
    data = rng.integers(0, 256, (B, 223), dtype=np.uint8)
    parity = np.asarray(RS.encode(data))
    nerr = rng.integers(0, 17, B)
    nerr[:8] = 0
    word = corrupt_symbols(np.concatenate([data, parity], 1), nerr, rng)
    junk = np.arange(100, 108)
    word[junk] = rng.integers(0, 256, (8, 255), dtype=np.uint8)
    ok, d, p, c = _host(RS.decode(word[:, :223], word[:, 223:]))
    good = np.ones(B, bool)
    good[junk] = False
    assert ok[good].all() and not ok[junk].any()
    np.testing.assert_array_equal(d[good], data[good])
    np.testing.assert_array_equal(p[good], parity[good])
    np.testing.assert_array_equal(c[good], nerr[good])
    _assert_same((ok, d, p, c),
                 _host(RS._decode_plain(word[:, :223], word[:, 223:])))


def test_rs_erasure_mixed_counts():
    """0..32 erasures per row (per-row counts and positions): every row
    is restored; the count is the number of nonzero corrections."""
    rng = np.random.default_rng(21)
    B, E = 128, 32
    data = rng.integers(0, 256, (B, 223), dtype=np.uint8)
    parity = np.asarray(RS.encode(data))
    pos = np.zeros((B, E), np.int32)
    cnt = rng.integers(0, E + 1, B).astype(np.int32)
    bad = data.copy()
    for i in range(B):
        p = np.sort(rng.choice(223, cnt[i], replace=False))
        pos[i, : cnt[i]] = p
        bad[i, p] ^= rng.integers(1, 256, cnt[i]).astype(np.uint8)
    ok, d, p, c = _host(RS.decode(bad, parity, erasures=(pos, cnt)))
    assert ok.all()
    np.testing.assert_array_equal(d, data)
    np.testing.assert_array_equal(p, parity)
    np.testing.assert_array_equal(c, cnt)


def test_rs_erasure_narrow_positions_plus_errors():
    """E < num_roots erasures given in an array exactly E wide, plus
    unflagged errors within the remaining budget.  The locator then has
    more roots than position slots; the extra corrections land in the
    zero-padded slots, i.e. at data[0] (decode.c:211-214 applies each
    correction at the caller's erasure position j), while ok stays True
    because the syndrome re-verification uses the true locations."""
    rng = np.random.default_rng(5)
    B, E = 64, 8
    data = rng.integers(0, 256, (B, 223), dtype=np.uint8)
    parity = np.asarray(RS.encode(data))
    pos = np.stack([np.sort(rng.choice(np.arange(1, 223), E + 1, replace=False))
                    for _ in range(B)]).astype(np.int32)
    extra, pos = pos[:, -1], pos[:, :E]          # one unflagged error per row
    bad = data.copy()
    rows = np.arange(B)[:, None]
    bad[rows, pos] ^= rng.integers(1, 256, (B, E)).astype(np.uint8)
    e_val = rng.integers(1, 256, B).astype(np.uint8)
    bad[np.arange(B), extra] ^= e_val
    cnt = np.full(B, E, np.int32)
    ok, d, p, c = _host(RS.decode(bad, parity, erasures=(pos, cnt)))
    assert ok.all()
    want = data.copy()
    want[np.arange(B), extra] ^= e_val           # left uncorrected
    want[:, 0] ^= e_val                          # applied at padded slot 0
    np.testing.assert_array_equal(d, want)
    np.testing.assert_array_equal(c, E + 1)


def test_rs_ext_syndrome_host_syndromes():
    """External log-form syndromes computed on the host from the error
    pattern; all-sentinel rows mean 'no error' and pass through."""
    rng = np.random.default_rng(22)
    B = 128
    data = rng.integers(0, 256, (B, 223), dtype=np.uint8)
    parity = np.asarray(RS.encode(data))
    nerr = rng.integers(0, 5, B)
    nerr[:8] = 0
    clean = np.concatenate([data, parity], 1)
    word = corrupt_symbols(clean, nerr, rng)
    s_log = host_syndromes_log(word ^ clean, RSConfig())
    assert (s_log[:8] == RS.fs).all()
    ok, d, p, c = _host(RS.decode(word[:, :223], word[:, 223:],
                                  ext_syndrome=s_log))
    assert ok.all()
    np.testing.assert_array_equal(d, data)
    np.testing.assert_array_equal(p, parity)
    np.testing.assert_array_equal(c, nerr)
    # the same syndromes as the codec computes itself
    s_dev = np.asarray(RS._syndrome(word[:, :223], word[:, 223:]))
    np.testing.assert_array_equal(RS.gf.exp2log[s_dev], s_log)


def test_rs_shortened_ragged_batch():
    rng = np.random.default_rng(5)
    B, size = 70, 100
    data = rng.integers(0, 256, (B, size), dtype=np.uint8)
    parity = np.asarray(RS.encode(data))
    bad = data.copy()
    bad[:, 3] ^= 0x7E
    bad[:, 77] ^= 0x01
    ok, d, p, c = _host(RS.decode(bad, parity))
    assert ok.all() and (c == 2).all()
    np.testing.assert_array_equal(d, data)
    np.testing.assert_array_equal(p, parity)


# ---------------------------------------------------------------- LDPC

LDPC_CONFIGS = [
    pytest.param(dict(block_size=128, rate=LdpcRate.RATE_1_2), id="128B-r12-random"),
    pytest.param(dict(block_size=64, rate=LdpcRate.RATE_1_3), id="64B-r13-random"),
    pytest.param(dict(block_size=128, rate=LdpcRate.RATE_1_2,
                      matrix_type=LdpcMatrixType.QC_RANDOM), id="128B-r12-qc"),
    pytest.param(dict(block_size=64, rate=LdpcRate.RATE_1_2, column_weight=7),
                 id="64B-r12-cw7"),
]

_LDPC: dict = {}


def ldpc(**kw) -> LDPCCodec:
    key = tuple(sorted(kw.items()))
    if key not in _LDPC:
        _LDPC[key] = LDPCCodec(LdpcConfig(**kw))
    return _LDPC[key]


def _codewords(c, B, rng, max_flips=6):
    info = rng.integers(0, 256, (B, c.info_bytes), dtype=np.uint8)
    cw = np.concatenate([info, np.asarray(c.encode(info))], axis=1)
    nflip = rng.integers(0, max_flips + 1, B)
    bad = cw.copy()
    for k in range(1, max_flips + 1):
        rows = nflip == k
        if rows.any():
            bad[rows] = flip_bits(cw[rows], k, rng)
    return cw, bad


@pytest.mark.parametrize("B", [1023, 1024, 1025, 2500])
def test_ldpc_hard_around_chunk_width(B):
    """Batches just under, at, just over and well past DECODE_CHUNK are
    padded and chunked, and return exactly what one unchunked decode
    returns; converged rows are the encoded codewords."""
    c = ldpc(block_size=128, rate=LdpcRate.RATE_1_2)
    whole = ldpc(block_size=128, rate=LdpcRate.RATE_1_2, decode_chunk=1 << 30)
    rng = np.random.default_rng(B)
    cw, bad = _codewords(c, B, rng)
    got = _host(c.decode_hard(bad))
    _assert_same(got, _host(whole.decode_hard(bad)))
    ok, out, iters = got
    assert ok.mean() > 0.95
    np.testing.assert_array_equal(out[ok], cw[ok])


@pytest.mark.parametrize("kw", LDPC_CONFIGS)
def test_ldpc_budget_exhaustion(kw):
    """One iteration under heavy noise: unconverged rows return the
    iteration-1 hard decision with ok=False and the full budget as their
    count, the same chunked and unchunked."""
    c = ldpc(decode_chunk=256, **kw)
    whole = ldpc(decode_chunk=1 << 30, **kw)
    rng = np.random.default_rng(6)
    info = rng.integers(0, 256, (600, c.info_bytes), dtype=np.uint8)
    cw = np.concatenate([info, np.asarray(c.encode(info))], axis=1)
    bad = flip_bits(cw, c.codeword_bits // 8, rng)
    got = _host(c.decode_hard(bad, 1))
    _assert_same(got, _host(whole.decode_hard(bad, 1)))
    ok, _, iters = got
    assert not ok.all()
    assert (iters[~ok] == 1).all()


@pytest.mark.parametrize("kw", LDPC_CONFIGS)
def test_ldpc_soft_ragged(kw):
    """A ragged soft batch (300 rows, chunk 128) through the padded
    adaptive cascade equals one full-budget decode."""
    c = ldpc(decode_chunk=128, adaptive_straggler_slots=32, **kw)
    rng = np.random.default_rng(7)
    info = rng.integers(0, 256, (300, c.info_bytes), dtype=np.uint8)
    cw = np.concatenate([info, np.asarray(c.encode(info))], axis=1)
    cb = bitutils.unpack_np(cw, c.codeword_bits)
    llr = np.where(cb == 1, -90, 90) + rng.integers(-60, 61, cb.shape)
    llr = llr.clip(-127, 127).astype(np.int8)
    full = _host(c.decode_soft(llr))
    _assert_same(_host(c.decode_soft_adaptive(llr)), full)
    ok, out, _ = full
    np.testing.assert_array_equal(out[ok], cw[ok])


def test_ldpc_clean_batch():
    """A clean ragged batch exits before the first iteration."""
    c = ldpc(block_size=128, rate=LdpcRate.RATE_1_2)
    rng = np.random.default_rng(8)
    info = rng.integers(0, 256, (1025, c.info_bytes), dtype=np.uint8)
    cw = np.concatenate([info, np.asarray(c.encode(info))], axis=1)
    ok, out, iters = _host(c.decode_hard(cw))
    assert ok.all() and (iters == 0).all()
    np.testing.assert_array_equal(out, cw)


@pytest.mark.parametrize("preset", ["default", "burst", "qc"])
def test_adaptive_equals_full_budget(preset):
    """The adaptive cascade (short first stage, straggler passes) is
    bit-identical to one full-budget decode for every shipped preset."""
    cfg = {
        "default": pp.ldpc_config_default(128, LdpcRate.RATE_1_2),
        "burst": pp.ldpc_config_burst_resistant(128, LdpcRate.RATE_1_2),
        "qc": LdpcConfig(block_size=128, rate=LdpcRate.RATE_1_2,
                         matrix_type=LdpcMatrixType.QC_RANDOM),
    }[preset]
    c = LDPCCodec(dataclasses.replace(cfg, decode_chunk=512,
                                      adaptive_straggler_slots=16))
    rng = np.random.default_rng(9)
    cw, bad = _codewords(c, 1500, rng, max_flips=8)
    full = _host(c.decode_hard(bad))
    _assert_same(_host(c.decode_hard_adaptive(bad)), full)
    ok, out, _ = full
    assert not ok.all()                 # stragglers really reach stage 2
    np.testing.assert_array_equal(out[ok], cw[ok])
