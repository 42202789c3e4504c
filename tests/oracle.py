"""ctypes wrapper around the *unmodified* reference C library.

This is the golden-compat harness (the moral equivalent of the
reference's tests/fec_compat.c): the reference sources under
/root/reference are compiled out-of-tree into a shared library and every
codec in libpoporon_jax is asserted byte-identical against it on shared
random vectors.  No reference code is copied into this repo.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
REF = Path(os.environ.get("POPORON_REFERENCE", "/root/reference"))
SO = REPO / ".oracle_build" / "libpoporon_oracle.so"

FEC_RS, FEC_LDPC, FEC_BCH = 1, 2, 3


def _build() -> None:
    SO.parent.mkdir(exist_ok=True)
    srcs = sorted(str(p) for p in (REF / "src").glob("*.c"))
    cmd = [
        "gcc", "-O2", "-fPIC", "-shared",
        f"-I{REF}/include", f"-I{REF}/src",
        *srcs, "-o", str(SO),
    ]
    subprocess.run(cmd, check=True, capture_output=True)


def available() -> bool:
    if SO.exists():
        return True
    if not REF.exists():
        return False
    try:
        _build()
        return True
    except Exception:
        return False


class _GfStruct(ct.Structure):
    # mirror of struct _poporon_gf_t (reference src/internal/common.h:46-52)
    _fields_ = [
        ("symbol_size", ct.c_uint8),
        ("field_size", ct.c_uint8),
        ("log2exp", ct.POINTER(ct.c_uint16)),
        ("exp2log", ct.POINTER(ct.c_uint16)),
        ("generator_polynomial", ct.c_uint16),
    ]


class _SparseMatrix(ct.Structure):
    # mirror of sparse_matrix_t (reference src/internal/ldpc.h:51-57)
    _fields_ = [
        ("row_ptr", ct.POINTER(ct.c_uint32)),
        ("col_idx", ct.POINTER(ct.c_uint32)),
        ("num_checks", ct.c_uint32),
        ("num_bits", ct.c_uint32),
        ("num_edges", ct.c_uint32),
    ]


class _ColumnView(ct.Structure):
    _fields_ = [
        ("col_ptr", ct.POINTER(ct.c_uint32)),
        ("row_idx", ct.POINTER(ct.c_uint32)),
        ("edge_idx", ct.POINTER(ct.c_uint32)),
    ]


class _Messages(ct.Structure):
    _fields_ = [
        ("check_to_var", ct.POINTER(ct.c_int16)),
        ("var_to_check", ct.POINTER(ct.c_int16)),
        ("llr_total", ct.POINTER(ct.c_int16)),
    ]


class _Interleaver(ct.Structure):
    _fields_ = [
        ("forward", ct.POINTER(ct.c_uint32)),
        ("inverse", ct.POINTER(ct.c_uint32)),
        ("size", ct.c_size_t),
        ("depth", ct.c_uint32),
    ]


class _OuterInterleaver(ct.Structure):
    _fields_ = [
        ("forward", ct.POINTER(ct.c_uint32)),
        ("inverse", ct.POINTER(ct.c_uint32)),
        ("size", ct.c_size_t),
    ]


class _LdpcParams(ct.Structure):
    # mirror of poporon_ldpc_params_t (reference src/internal/ldpc.h:19-27)
    _fields_ = [
        ("matrix_type", ct.c_int),
        ("column_weight", ct.c_uint32),
        ("use_inner_interleave", ct.c_bool),
        ("use_outer_interleave", ct.c_bool),
        ("interleave_depth", ct.c_uint32),
        ("lifting_factor", ct.c_uint32),
        ("seed", ct.c_uint64),
    ]


class _LdpcStruct(ct.Structure):
    # mirror of struct _poporon_ldpc_t (reference src/internal/ldpc.h:84-103)
    _fields_ = [
        ("rate", ct.c_int),
        ("config", _LdpcParams),
        ("info_bits", ct.c_size_t),
        ("parity_bits", ct.c_size_t),
        ("codeword_bits", ct.c_size_t),
        ("info_bytes", ct.c_size_t),
        ("parity_bytes", ct.c_size_t),
        ("codeword_bytes", ct.c_size_t),
        ("parity_matrix", _SparseMatrix),
        ("parity_matrix_cols", _ColumnView),
        ("msg", _Messages),
        ("interleaver", _Interleaver),
        ("outer_interleaver", _OuterInterleaver),
        ("temp_codeword", ct.POINTER(ct.c_uint8)),
        ("temp_interleaved", ct.POINTER(ct.c_uint8)),
        ("temp_outer", ct.POINTER(ct.c_uint8)),
    ]


_lib = None


def lib() -> ct.CDLL:
    global _lib
    if _lib is None:
        if not available():
            raise RuntimeError("reference oracle not available")
        L = ct.CDLL(str(SO))
        L.poporon_rng_create.restype = ct.c_void_p
        L.poporon_rng_create.argtypes = [ct.c_int, ct.c_void_p, ct.c_size_t]
        L.poporon_rng_next.restype = ct.c_bool
        L.poporon_rng_next.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_size_t]
        L.poporon_rng_destroy.argtypes = [ct.c_void_p]

        L.poporon_gf_create.restype = ct.POINTER(_GfStruct)
        L.poporon_gf_create.argtypes = [ct.c_uint8, ct.c_uint16]
        L.poporon_gf_destroy.argtypes = [ct.c_void_p]
        L.poporon_gf_mod.restype = ct.c_uint8
        L.poporon_gf_mod.argtypes = [ct.c_void_p, ct.c_uint16]

        L.poporon_rs_config_create.restype = ct.c_void_p
        L.poporon_rs_config_create.argtypes = [
            ct.c_uint8, ct.c_uint16, ct.c_uint16, ct.c_uint16, ct.c_uint8,
            ct.c_void_p, ct.c_void_p,
        ]
        L.poporon_ldpc_config_create.restype = ct.c_void_p
        L.poporon_ldpc_config_create.argtypes = [
            ct.c_size_t, ct.c_int, ct.c_int, ct.c_uint32,
            ct.c_bool, ct.c_bool, ct.c_bool,
            ct.c_uint32, ct.c_uint32, ct.c_uint32,
            ct.c_void_p, ct.c_size_t, ct.c_uint64,
        ]
        L.poporon_bch_config_create.restype = ct.c_void_p
        L.poporon_bch_config_create.argtypes = [ct.c_uint8, ct.c_uint16, ct.c_uint8]
        L.poporon_config_destroy.argtypes = [ct.c_void_p]

        L.poporon_create.restype = ct.c_void_p
        L.poporon_create.argtypes = [ct.c_void_p]
        L.poporon_destroy.argtypes = [ct.c_void_p]
        L.poporon_encode.restype = ct.c_bool
        L.poporon_encode.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_size_t, ct.c_void_p]
        L.poporon_decode.restype = ct.c_bool
        L.poporon_decode.argtypes = [
            ct.c_void_p, ct.c_void_p, ct.c_size_t, ct.c_void_p,
            ct.POINTER(ct.c_size_t),
        ]
        L.poporon_get_parity_size.restype = ct.c_size_t
        L.poporon_get_parity_size.argtypes = [ct.c_void_p]
        L.poporon_get_info_size.restype = ct.c_size_t
        L.poporon_get_info_size.argtypes = [ct.c_void_p]
        L.poporon_get_iterations_used.restype = ct.c_uint32
        L.poporon_get_iterations_used.argtypes = [ct.c_void_p]

        L.poporon_erasure_create_from_positions.restype = ct.c_void_p
        L.poporon_erasure_create_from_positions.argtypes = [
            ct.c_uint16, ct.POINTER(ct.c_uint32), ct.c_uint32,
        ]
        L.poporon_erasure_destroy.argtypes = [ct.c_void_p]

        L.poporon_bch_create.restype = ct.c_void_p
        L.poporon_bch_create.argtypes = [ct.c_uint8, ct.c_uint16, ct.c_uint8]
        L.poporon_bch_destroy.argtypes = [ct.c_void_p]
        L.poporon_bch_encode.restype = ct.c_bool
        L.poporon_bch_encode.argtypes = [ct.c_void_p, ct.c_uint32, ct.POINTER(ct.c_uint32)]
        L.poporon_bch_decode.restype = ct.c_bool
        L.poporon_bch_decode.argtypes = [
            ct.c_void_p, ct.c_uint32, ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int32),
        ]
        L.poporon_bch_get_codeword_length.restype = ct.c_uint16
        L.poporon_bch_get_codeword_length.argtypes = [ct.c_void_p]
        L.poporon_bch_get_data_length.restype = ct.c_uint16
        L.poporon_bch_get_data_length.argtypes = [ct.c_void_p]

        L.poporon_ldpc_create.restype = ct.POINTER(_LdpcStruct)
        L.poporon_ldpc_create.argtypes = [ct.c_size_t, ct.c_int, ct.POINTER(_LdpcParams)]
        L.poporon_ldpc_destroy.argtypes = [ct.c_void_p]
        L.poporon_ldpc_encode.restype = ct.c_bool
        L.poporon_ldpc_encode.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_void_p]
        L.poporon_ldpc_decode_hard.restype = ct.c_bool
        L.poporon_ldpc_decode_hard.argtypes = [
            ct.c_void_p, ct.c_void_p, ct.c_uint32, ct.POINTER(ct.c_uint32),
        ]
        L.poporon_ldpc_decode_soft.restype = ct.c_bool
        L.poporon_ldpc_decode_soft.argtypes = [
            ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_uint32, ct.POINTER(ct.c_uint32),
        ]
        _lib = L
    return _lib


# ---------------------------------------------------------------- RNG

def rng_stream(seed: int, nbytes: int) -> bytes:
    L = lib()
    s = ct.c_uint32(seed & 0xFFFFFFFF)
    r = L.poporon_rng_create(0, ct.byref(s), 4)
    buf = (ct.c_uint8 * nbytes)()
    assert L.poporon_rng_next(r, buf, nbytes)
    L.poporon_rng_destroy(r)
    return bytes(buf)


# ----------------------------------------------------------------- GF

def gf_tables(symbol_size: int, poly: int):
    """Returns (log2exp, exp2log) uint16 arrays, or None if create fails."""
    L = lib()
    gfp = L.poporon_gf_create(symbol_size, poly)
    if not gfp:
        return None
    gf = gfp.contents
    n = (1 << symbol_size) - 1
    log2exp = np.ctypeslib.as_array(gf.log2exp, shape=(n + 1,)).copy()
    exp2log = np.ctypeslib.as_array(gf.exp2log, shape=(n + 1,)).copy()
    L.poporon_gf_destroy(gfp)
    return log2exp, exp2log


# ----------------------------------------------------------------- RS

class RS:
    """Facade-level RS oracle (encode/decode, erasure, external syndrome)."""

    def __init__(self, symbol_size=8, poly=0x11D, fcr=1, prim=1, num_roots=32,
                 erasure_positions=None, ext_syndrome=None):
        L = lib()
        self._L = L
        self._eras = None
        self._synd = None
        eras_p = None
        synd_p = None
        if erasure_positions is not None:
            pos = np.asarray(erasure_positions, dtype=np.uint32)
            arr = pos.ctypes.data_as(ct.POINTER(ct.c_uint32))
            self._eras = L.poporon_erasure_create_from_positions(
                num_roots, arr, len(pos))
            eras_p = self._eras
        if ext_syndrome is not None:
            self._synd = np.asarray(ext_syndrome, dtype=np.uint16).copy()
            synd_p = self._synd.ctypes.data_as(ct.c_void_p)
        cfg = L.poporon_rs_config_create(
            symbol_size, poly, fcr, prim, num_roots, eras_p, synd_p)
        self._h = L.poporon_create(cfg)
        L.poporon_config_destroy(cfg)
        assert self._h, "oracle RS create failed"
        self.num_roots = num_roots

    def encode(self, data: np.ndarray) -> np.ndarray:
        d = np.ascontiguousarray(data, dtype=np.uint8).copy()
        parity = np.zeros(self.num_roots, dtype=np.uint8)
        ok = self._L.poporon_encode(
            self._h, d.ctypes.data_as(ct.c_void_p), len(d),
            parity.ctypes.data_as(ct.c_void_p))
        assert ok
        return parity

    def decode(self, data: np.ndarray, parity: np.ndarray):
        d = np.ascontiguousarray(data, dtype=np.uint8).copy()
        p = np.ascontiguousarray(parity, dtype=np.uint8).copy()
        n = ct.c_size_t(0)
        ok = self._L.poporon_decode(
            self._h, d.ctypes.data_as(ct.c_void_p), len(d),
            p.ctypes.data_as(ct.c_void_p), ct.byref(n))
        return bool(ok), d, p, int(n.value)

    def close(self):
        if self._h:
            self._L.poporon_destroy(self._h)
            self._h = None
        if self._eras:
            self._L.poporon_erasure_destroy(self._eras)
            self._eras = None


# ---------------------------------------------------------------- BCH

class BCH:
    def __init__(self, symbol_size=4, poly=0x13, t=3):
        L = lib()
        self._L = L
        self._h = L.poporon_bch_create(symbol_size, poly, t)
        assert self._h, "oracle BCH create failed"
        self.codeword_length = L.poporon_bch_get_codeword_length(self._h)
        self.data_length = L.poporon_bch_get_data_length(self._h)

    def encode(self, data: int):
        cw = ct.c_uint32(0)
        ok = self._L.poporon_bch_encode(self._h, data, ct.byref(cw))
        return bool(ok), cw.value

    def decode(self, received: int):
        cw = ct.c_uint32(0)
        ne = ct.c_int32(0)
        ok = self._L.poporon_bch_decode(self._h, received, ct.byref(cw), ct.byref(ne))
        return bool(ok), cw.value, ne.value

    def close(self):
        if self._h:
            self._L.poporon_bch_destroy(self._h)
            self._h = None


class BCHFacade:
    """Byte-level BCH via the unified facade (encode.c:199-234 semantics)."""

    def __init__(self, symbol_size=4, poly=0x13, t=3):
        L = lib()
        self._L = L
        cfg = L.poporon_bch_config_create(symbol_size, poly, t)
        self._h = L.poporon_create(cfg)
        L.poporon_config_destroy(cfg)
        assert self._h
        self.parity_size = L.poporon_get_parity_size(self._h)
        self.info_size = L.poporon_get_info_size(self._h)

    def encode(self, data: np.ndarray) -> np.ndarray:
        d = np.ascontiguousarray(data, dtype=np.uint8).copy()
        parity = np.zeros(self.parity_size, dtype=np.uint8)
        ok = self._L.poporon_encode(
            self._h, d.ctypes.data_as(ct.c_void_p), len(d),
            parity.ctypes.data_as(ct.c_void_p))
        assert ok
        return parity

    def decode(self, data: np.ndarray, parity: np.ndarray):
        d = np.ascontiguousarray(data, dtype=np.uint8).copy()
        p = np.ascontiguousarray(parity, dtype=np.uint8).copy()
        n = ct.c_size_t(0)
        ok = self._L.poporon_decode(
            self._h, d.ctypes.data_as(ct.c_void_p), len(d),
            p.ctypes.data_as(ct.c_void_p), ct.byref(n))
        return bool(ok), d, p, int(n.value)

    def close(self):
        if self._h:
            self._L.poporon_destroy(self._h)
            self._h = None


# --------------------------------------------------------------- LDPC

def _params(matrix_type=1, column_weight=3, inner=False, outer=False,
            depth=0, lifting=0, seed=0) -> _LdpcParams:
    p = _LdpcParams()
    p.matrix_type = matrix_type
    p.column_weight = column_weight
    p.use_inner_interleave = inner
    p.use_outer_interleave = outer
    p.interleave_depth = depth
    p.lifting_factor = lifting
    p.seed = seed
    return p


class LDPC:
    """Internal-API LDPC oracle with structure introspection."""

    def __init__(self, block_size, rate, **kw):
        L = lib()
        self._L = L
        self._p = L.poporon_ldpc_create(block_size, rate, ct.byref(_params(**kw)))
        assert self._p, "oracle LDPC create failed"
        s = self._p.contents
        self.info_bits = s.info_bits
        self.parity_bits = s.parity_bits
        self.codeword_bits = s.codeword_bits
        self.info_bytes = s.info_bytes
        self.parity_bytes = s.parity_bytes
        self.codeword_bytes = s.codeword_bytes

    def structure(self):
        s = self._p.contents
        nc, ne = s.parity_matrix.num_checks, s.parity_matrix.num_edges
        row_ptr = np.ctypeslib.as_array(s.parity_matrix.row_ptr, shape=(nc + 1,)).copy()
        used = int(row_ptr[-1])
        col_idx = np.ctypeslib.as_array(s.parity_matrix.col_idx, shape=(ne,)).copy()
        return dict(row_ptr=row_ptr, col_idx=col_idx[:used], num_edges=ne)

    def interleavers(self):
        s = self._p.contents
        out = {}
        if s.interleaver.forward:
            out["inner_forward"] = np.ctypeslib.as_array(
                s.interleaver.forward, shape=(s.codeword_bits,)).copy()
            out["inner_depth"] = s.interleaver.depth
        if s.outer_interleaver.forward:
            out["outer_forward"] = np.ctypeslib.as_array(
                s.outer_interleaver.forward, shape=(s.info_bytes,)).copy()
        return out

    def encode(self, info: np.ndarray) -> np.ndarray:
        d = np.ascontiguousarray(info, dtype=np.uint8)
        parity = np.zeros(self.parity_bytes, dtype=np.uint8)
        ok = self._L.poporon_ldpc_encode(
            self._p, d.ctypes.data_as(ct.c_void_p),
            parity.ctypes.data_as(ct.c_void_p))
        assert ok
        return parity

    def decode_hard(self, codeword: np.ndarray, max_iterations=0):
        cw = np.ascontiguousarray(codeword, dtype=np.uint8).copy()
        it = ct.c_uint32(0)
        ok = self._L.poporon_ldpc_decode_hard(
            self._p, cw.ctypes.data_as(ct.c_void_p), max_iterations, ct.byref(it))
        return bool(ok), cw, int(it.value)

    def decode_soft(self, llr: np.ndarray, max_iterations=0):
        l8 = np.ascontiguousarray(llr, dtype=np.int8)
        cw = np.zeros(self.codeword_bytes, dtype=np.uint8)
        it = ct.c_uint32(0)
        ok = self._L.poporon_ldpc_decode_soft(
            self._p, l8.ctypes.data_as(ct.c_void_p),
            cw.ctypes.data_as(ct.c_void_p), max_iterations, ct.byref(it))
        return bool(ok), cw, int(it.value)

    def close(self):
        if self._p:
            self._L.poporon_ldpc_destroy(self._p)
            self._p = None


class LDPCFacade:
    """Facade-level LDPC oracle (poporon_encode/decode semantics)."""

    def __init__(self, block_size, rate, matrix_type=1, column_weight=3,
                 use_soft=False, outer=False, inner=False, depth=0, lifting=0,
                 max_iterations=0, soft_llr=None, seed=0):
        L = lib()
        self._L = L
        self._llr = None
        llr_p, llr_n = None, 0
        if soft_llr is not None:
            self._llr = np.ascontiguousarray(soft_llr, dtype=np.int8)
            llr_p = self._llr.ctypes.data_as(ct.c_void_p)
            llr_n = len(self._llr)
        cfg = L.poporon_ldpc_config_create(
            block_size, rate, matrix_type, column_weight, use_soft,
            outer, inner, depth, lifting, max_iterations, llr_p, llr_n, seed)
        self._h = L.poporon_create(cfg)
        L.poporon_config_destroy(cfg)
        assert self._h, "oracle LDPC facade create failed"
        self.parity_size = L.poporon_get_parity_size(self._h)
        self.info_size = L.poporon_get_info_size(self._h)

    def encode(self, data: np.ndarray):
        """Returns (mutated_data, parity) — the reference mutates data in
        place when interleaving (encode.c:170, 192-193)."""
        d = np.ascontiguousarray(data, dtype=np.uint8).copy()
        parity = np.zeros(self.parity_size, dtype=np.uint8)
        ok = self._L.poporon_encode(
            self._h, d.ctypes.data_as(ct.c_void_p), len(d),
            parity.ctypes.data_as(ct.c_void_p))
        assert ok
        return d, parity

    def decode(self, data: np.ndarray, parity: np.ndarray):
        d = np.ascontiguousarray(data, dtype=np.uint8).copy()
        p = np.ascontiguousarray(parity, dtype=np.uint8).copy()
        n = ct.c_size_t(0)
        ok = self._L.poporon_decode(
            self._h, d.ctypes.data_as(ct.c_void_p), len(d),
            p.ctypes.data_as(ct.c_void_p), ct.byref(n))
        iters = self._L.poporon_get_iterations_used(self._h)
        return bool(ok), d, p, int(n.value), int(iters)

    def close(self):
        if self._h:
            self._L.poporon_destroy(self._h)
            self._h = None
