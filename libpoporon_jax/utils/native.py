"""ctypes loader for the native C++ core, with transparent fallback.

The native library accelerates host-side structure construction (LDPC
graph builds draw up to ~1M sequential xoshiro values) and bit staging.
If the .so is missing it is built on demand with make; if that fails,
callers fall back to the pure-NumPy/Python implementations — results
are identical either way (asserted in tests/test_native.py).
"""

from __future__ import annotations

import ctypes as ct
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent.parent / "native"
_SO = _DIR / "libpoporon_jax_core.so"

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        if not _SO.exists():
            subprocess.run(
                ["make", "-C", str(_DIR)], check=True, capture_output=True
            )
        L = ct.CDLL(str(_SO))
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        L.pptpu_xoshiro_fill_u32.argtypes = [ct.c_uint32, u32p, ct.c_uint64]
        L.pptpu_xoshiro_fill_bytes.argtypes = [ct.c_uint32, u8p, ct.c_uint64]
        L.pptpu_fisher_yates.argtypes = [ct.c_uint32, u32p, ct.c_uint64]
        L.pptpu_ldpc_build_random.restype = ct.c_uint64
        L.pptpu_ldpc_build_random.argtypes = [
            ct.c_uint32, ct.c_uint64, ct.c_uint64, ct.c_uint32, u32p, u32p,
        ]
        L.pptpu_ldpc_build_qc.restype = ct.c_uint64
        L.pptpu_ldpc_build_qc.argtypes = [
            ct.c_uint32, ct.c_uint64, ct.c_uint64, ct.c_uint32, ct.c_uint32,
            u32p, u32p,
        ]
        L.pptpu_unpack_bits.argtypes = [u8p, u8p, ct.c_uint64, ct.c_uint64, ct.c_uint64]
        L.pptpu_pack_bits.argtypes = [u8p, u8p, ct.c_uint64, ct.c_uint64, ct.c_uint64]
        _lib = L
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def xoshiro_fill_u32(seed: int, count: int) -> np.ndarray | None:
    L = _load()
    if L is None:
        return None
    out = np.empty(count, dtype=np.uint32)
    L.pptpu_xoshiro_fill_u32(seed & 0xFFFFFFFF, out, count)
    return out


def fisher_yates(seed: int, n: int) -> np.ndarray | None:
    L = _load()
    if L is None:
        return None
    out = np.empty(n, dtype=np.uint32)
    L.pptpu_fisher_yates(seed & 0xFFFFFFFF, out, n)
    return out


def ldpc_build_random(seed: int, info_bits: int, parity_bits: int,
                      col_weight: int, alloc_edges: int):
    L = _load()
    if L is None:
        return None
    row_ptr = np.zeros(parity_bits + 1, dtype=np.uint32)
    col_idx = np.zeros(alloc_edges, dtype=np.uint32)
    used = L.pptpu_ldpc_build_random(
        seed & 0xFFFFFFFF, info_bits, parity_bits, col_weight, row_ptr, col_idx
    )
    return row_ptr.astype(np.int64), col_idx[:used].astype(np.int64)


def ldpc_build_qc(seed: int, info_bits: int, parity_bits: int, col_weight: int,
                  lifting: int, alloc_edges: int):
    L = _load()
    if L is None:
        return None
    row_ptr = np.zeros(parity_bits + 1, dtype=np.uint32)
    col_idx = np.zeros(alloc_edges, dtype=np.uint32)
    used = L.pptpu_ldpc_build_qc(
        seed & 0xFFFFFFFF, info_bits, parity_bits, col_weight, lifting,
        row_ptr, col_idx,
    )
    return row_ptr.astype(np.int64), col_idx[:used].astype(np.int64)
