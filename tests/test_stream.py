"""Streaming framing round-trip tests."""

import numpy as np
import pytest

import libpoporon_jax as pp
from libpoporon_jax.config import LdpcRate
from libpoporon_jax.stream import StreamCodec


@pytest.mark.parametrize("n", [0, 1, 100, 223, 5000])
def test_rs_stream_roundtrip(n):
    sc = StreamCodec(pp.create(pp.rs_config_default()))
    payload = bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
    blob = sc.encode_stream(payload)
    out, stats = sc.decode_stream(blob)
    assert out == payload
    assert stats["blocks_failed"] == 0


def test_rs_stream_corrects_errors():
    sc = StreamCodec(pp.create(pp.rs_config_default()))
    rng = np.random.default_rng(0)
    payload = bytes(rng.integers(0, 256, 2000, dtype=np.uint8))
    blob = bytearray(sc.encode_stream(payload))
    # corrupt a few bytes in each block
    bs = sc.block_size
    for blk in range(len(blob) // bs):
        for _ in range(4):
            blob[blk * bs + int(rng.integers(0, bs))] ^= 0x5A
    out, stats = sc.decode_stream(bytes(blob))
    assert out == payload


def test_ldpc_stream_roundtrip():
    cfg = pp.LdpcConfig(block_size=64, rate=LdpcRate.RATE_1_2)
    sc = StreamCodec(pp.create(cfg))
    payload = b"hello poporon jax" * 40
    blob = sc.encode_stream(payload)
    out, stats = sc.decode_stream(blob)
    assert out == payload
