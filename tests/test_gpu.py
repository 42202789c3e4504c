"""Facade round trips on the GPU against the CPU backend, bit for bit.

Marked ``gpu``: they skip without a card.  Run them on one with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` (chip_smoke.py
does, as its first phase).
"""

import numpy as np
import pytest

import jax

import libpoporon_jax as pp
from libpoporon_jax.config import LdpcRate
from libpoporon_jax.utils import bits as bitutils

pytestmark = pytest.mark.gpu


def _decode_on(device, cfg, *args, **kwargs):
    with jax.default_device(device):
        res = pp.create(cfg).decode(*args, **kwargs)
        return [np.asarray(x) for x in res]


def _same_on_gpu_and_cpu(gpu, cfg, *args, **kwargs):
    got = _decode_on(gpu, cfg, *args, **kwargs)
    want = _decode_on(jax.devices("cpu")[0], cfg, *args, **kwargs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return got


def test_rs_plain_and_erasure(gpu_device):
    cfg = pp.rs_config_default()
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (4096, 223), dtype=np.uint8)
    parity = np.asarray(pp.create(cfg).encode(data).parity)
    bad = data.copy()
    bad[:, 7] ^= 0x5A
    bad[:, 100] ^= 0x01
    ok, d, _, _ = _same_on_gpu_and_cpu(gpu_device, cfg, bad, parity)
    assert ok.all() and (d == data).all()
    pos = np.arange(0, 64, 2, dtype=np.int32)
    bad = data.copy()
    bad[:, pos] ^= 0xFF
    ok, d, _, _ = _same_on_gpu_and_cpu(gpu_device, cfg, bad, parity,
                                       erasures=pos)
    assert ok.all() and (d == data).all()


def test_bch(gpu_device):
    cfg = pp.bch_config_default()
    rng = np.random.default_rng(1)
    data = rng.integers(0, 32, (4096, 1), dtype=np.uint8)
    parity = np.asarray(pp.create(cfg).encode(data).parity)
    bad = parity.copy()
    bad[:, 1] ^= rng.integers(0, 8, 4096).astype(np.uint8)  # 0-3 bit errors
    ok, d, _, _ = _same_on_gpu_and_cpu(gpu_device, cfg, data, bad)
    assert ok.all() and (d == data).all()


def test_ldpc_default_preset_hard(gpu_device):
    cfg = pp.ldpc_config_default(128, LdpcRate.RATE_1_2)
    rng = np.random.default_rng(2)
    info = rng.integers(0, 256, (4096, 128), dtype=np.uint8)
    enc = pp.create(cfg).encode(info.copy())
    d, p = np.asarray(enc.data).copy(), np.asarray(enc.parity)
    d[:, 11] ^= 0x20
    d[:, 60] ^= 0x01
    ok, out, _, _ = _same_on_gpu_and_cpu(gpu_device, cfg, d, p)
    assert ok.all() and (out == info).all()


def test_ldpc_soft(gpu_device):
    cfg = pp.ldpc_config_default(128, LdpcRate.RATE_1_2)
    rng = np.random.default_rng(3)
    info = rng.integers(0, 256, (4096, 128), dtype=np.uint8)
    enc = pp.create(cfg).encode(info.copy())
    cw = np.concatenate([np.asarray(enc.data), np.asarray(enc.parity)], 1)
    cb = bitutils.unpack_np(cw, 2048)
    llr = np.where(cb == 1, -90.0, 90.0) + rng.normal(0, 38.6, cb.shape)
    llr = np.clip(np.round(llr), -127, 127).astype(np.int8)
    ok, out, _, _ = _same_on_gpu_and_cpu(
        gpu_device, cfg, cw[:, :128], cw[:, 128:], soft_llr=llr)
    assert ok.mean() > 0.99
    assert (out[ok] == info[ok]).all()
