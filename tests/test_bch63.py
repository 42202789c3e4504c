"""BCH(63,51) — m = 6 spec tests.

The reference's support matrix lists BCH(63,51) with gen_poly 0x43 and
t = 2 (README.md:427), but its uint32 codeword packing makes m = 6
undefined behavior in C (n = 63 bits cannot fit; encode.c:215 and
decode.c:561 shift a uint32 by >= 32).  There is therefore no oracle to
compare against: these are SPEC tests — the mathematically defined BCH
behavior (t corrections succeed, verified failure beyond t, byte
round-trips) on the bit-tensor code path, which is well-defined for
every m.
"""

import numpy as np
import pytest

import libpoporon_jax as pp
from libpoporon_jax.models.bch import BCHCodec
from libpoporon_jax.ops.gf import GFError


@pytest.fixture(scope="module")
def codec():
    return BCHCodec(pp.BchConfig(6, 0x43, 2))


def test_construction(codec):
    assert codec.n == 63
    assert codec.data_length == 51
    assert codec.parity_bits == 12
    assert codec.t == 2
    # generator = lcm of minimal polys of alpha^1..alpha^4 over GF(64),
    # degree 12, and must divide x^63 - 1
    g = codec.gen_poly
    assert g.bit_length() - 1 == 12
    # remainder of x^63 + 1 by g(x) over GF(2) must be 0
    rem = (1 << 63) | 1
    for i in range(63, 11, -1):
        if rem & (1 << i):
            rem ^= g << (i - 12)
    assert rem == 0


def test_word_api_rejected(codec):
    with pytest.raises(GFError):
        codec.encode(np.array([1]))
    with pytest.raises(GFError):
        codec.decode(np.array([1]))


def _random_datawords(rng, n):
    return (rng.integers(0, 2, size=(n, 51))).astype(np.int32)


def test_encode_systematic_and_valid(codec):
    rng = np.random.default_rng(7)
    dbits = _random_datawords(rng, 64)
    cw = np.asarray(codec.encode_bits(dbits))
    assert cw.shape == (64, 63)
    # systematic: data bits occupy positions parity_bits..n-1
    np.testing.assert_array_equal(cw[:, 12:], dbits)
    # every codeword decodes clean with 0 errors
    ok, out, ne = map(np.asarray, codec.decode_bits(cw))
    assert ok.all() and (ne == 0).all()
    np.testing.assert_array_equal(out, cw)
    # host-side long-division encoder agrees with the matrix encoder
    for b in range(4):
        word = int(sum(int(dbits[b, i]) << i for i in range(51)))
        cw_host = codec._encode_word(word)
        bits_host = [(cw_host >> j) & 1 for j in range(63)]
        np.testing.assert_array_equal(cw[b], bits_host)


def test_all_single_and_double_errors_corrected(codec):
    rng = np.random.default_rng(8)
    dbits = _random_datawords(rng, 4)
    cw = np.asarray(codec.encode_bits(dbits))
    received = []
    expect = []
    for b in range(4):
        for i in range(63):
            r = cw[b].copy()
            r[i] ^= 1
            received.append(r)
            expect.append(cw[b])
        for i in range(0, 63, 7):
            for j in range(i + 1, 63, 5):
                r = cw[b].copy()
                r[i] ^= 1
                r[j] ^= 1
                received.append(r)
                expect.append(cw[b])
    received = np.array(received)
    ok, out, ne = map(np.asarray, codec.decode_bits(received))
    assert ok.all()
    np.testing.assert_array_equal(out, np.array(expect))
    # error counts match the number of flips
    nflip = (received != np.array(expect)).sum(axis=1)
    np.testing.assert_array_equal(ne, nflip)


def test_overload_fails_or_miscorrects_consistently(codec):
    """>t errors: decode must never claim success with a wrong-weight
    fix — ok implies the output is a valid codeword."""
    rng = np.random.default_rng(9)
    dbits = _random_datawords(rng, 32)
    cw = np.asarray(codec.encode_bits(dbits))
    received = cw.copy()
    for b in range(32):
        pos = rng.choice(63, 3, replace=False)
        received[b, pos] ^= 1
    ok, out, ne = map(np.asarray, codec.decode_bits(received))
    # whatever the ok verdict, claimed-ok outputs must be valid codewords
    ok2, _, ne2 = map(np.asarray, codec.decode_bits(out[ok]))
    assert ok2.all() and (ne2 == 0).all()
    # failures return the received word unchanged (best effort)
    np.testing.assert_array_equal(out[~ok], received[~ok])


def test_facade_byte_roundtrip():
    codec = pp.create(pp.BchConfig(6, 0x43, 2))
    assert codec.info_size == 7      # ceil(51 / 8)
    assert codec.parity_size == 2    # ceil(12 / 8)
    rng = np.random.default_rng(10)
    # top 5 bits of byte 0 fall outside the 51-bit dataword and are
    # masked off by packing — zero them so the round-trip is exact
    data = rng.integers(0, 256, (16, 7), dtype=np.uint8)
    data[:, 0] &= 0x07
    enc = codec.encode(data)
    parity = np.asarray(enc.parity)
    assert parity.shape == (16, 2)
    # corrupt 2 bits in one data byte -> must correct
    corrupt = np.asarray(enc.data).copy()
    corrupt[:, 3] ^= 0x21
    ok, d, p, corr = map(np.asarray, codec.decode(corrupt, parity))
    assert ok.all()
    np.testing.assert_array_equal(d, data)
    np.testing.assert_array_equal(corr, np.full(16, 2))
