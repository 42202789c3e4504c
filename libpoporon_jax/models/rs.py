"""Reed-Solomon codec, batched on the accelerator.

Re-design of the reference RS pipeline (src/rs.c, src/encode.c:17-145,
src/decode.c:17-487) for batched execution under XLA:

* The reference encodes ONE codeword per call with a scalar LFSR
  (encode.c:120-144) and computes syndromes with a scalar Horner loop
  (decode.c:375-415).  Both are GF(2)-LINEAR maps with fixed constants,
  so here they are precomputed 0/1 matrices applied to the whole
  [B, bits] batch with ONE matmul mod 2 (ops/gf2.py).  The
  Chien search's sequential register trick (decode.c:115-144), the
  error-evaluator evaluation and the formal-derivative evaluation of
  Forney (decode.c:160-191) are likewise dense bit-matmul evaluations
  at ALL field points, with per-root values compacted by fused one-hot
  einsums.

* The reference's table-driven log/antilog arithmetic becomes per-
  element gathers here.  Everything data-dependent (Berlekamp-Massey,
  Forney products) runs in NORMAL domain using packed-integer carry-
  less multiply + reduction (ops/gfint.py) — pure fused elementwise int
  ops.  The "log of zero" sentinel of the C code maps exactly to the
  value 0 here; the C's log-domain corner cases (division by a zero
  denominator yields a *= 1 via the sentinel, decode.c:187-189) are
  reproduced through an inverse table with inv[0] = 1.

* Berlekamp-Massey keeps its serial dependence (decode.c:49-96) but
  runs as a fixed-trip fori_loop with branchless selects, parallel over
  the batch.

* Shortened-code semantics (decode.c:418-429), erasure-locator init
  (decode.c:34-47), the external-syndrome path (decode.c:446-464),
  Forney's uint16 wraparound for fcr=0 (decode.c:175-176), and the
  partial in-place application on failure (decode.c:211-227) are
  replicated exactly; outputs are bit-identical to the C library
  (tests/test_oracle_compat.py) for all configurations whose
  verification exponent (fcr+nr)*prim*fs stays below 2^15 (the C
  truncates it into an int16, decode.c:201; larger configs are UB
  territory in the reference).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RSConfig
from ..ops import gfbit
from ..ops.gf import GF, GFError
from ..ops.gf2 import gf2_matmul
from ..ops.gfint import gf_mul, onehot_select, scatter_mod2, table_select


def _xor_reduce(x, axis: int):
    return jax.lax.reduce(x, np.int32(0), jax.lax.bitwise_xor, (axis,))


def _symbols_to_bits_np(sym: np.ndarray, m: int) -> np.ndarray:
    """[..., n] symbols -> [..., n*m] bits, MSB-first within each symbol."""
    shifts = np.arange(m - 1, -1, -1)
    bits = (sym[..., :, None] >> shifts) & 1
    return bits.reshape(*sym.shape[:-1], sym.shape[-1] * m).astype(np.uint8)


def _symbols_to_bits(sym, m: int):
    shifts = jnp.arange(m - 1, -1, -1, dtype=jnp.int32)
    bits = (sym[..., :, None] >> shifts) & 1
    return bits.reshape(*sym.shape[:-1], sym.shape[-1] * m)


def _bits_to_symbols(bits, m: int):
    n = bits.shape[-1] // m
    b = bits.reshape(*bits.shape[:-1], n, m).astype(jnp.int32)
    weights = jnp.left_shift(jnp.int32(1), jnp.arange(m - 1, -1, -1, dtype=jnp.int32))
    return (b * weights).sum(axis=-1)


def _build_genpoly(gf: GF, fcr: int, prim: int, num_roots: int) -> np.ndarray:
    """Generator polynomial prod_{i<nr}(x - alpha^{(fcr+i)*prim}), returned
    in LOG form (reference rs.c:59-80)."""
    fs = gf.field_size
    g = np.zeros(num_roots + 1, dtype=np.int64)
    g[0] = 1
    root = fcr * prim
    for i in range(num_roots):
        g[i + 1] = 1
        for j in range(i, 0, -1):
            if g[j] != 0:
                g[j] = g[j - 1] ^ int(
                    gf.log2exp[(int(gf.exp2log[g[j]]) + root) % fs]
                )
            else:
                g[j] = g[j - 1]
        g[0] = int(gf.log2exp[(int(gf.exp2log[g[0]]) + root) % fs])
        root += prim
    return gf.exp2log[g].astype(np.int64)  # log form; sentinel fs for zero coeffs


def _encode_np(gf: GF, genlog: np.ndarray, num_roots: int, data: np.ndarray) -> np.ndarray:
    """Batched NumPy systematic LFSR — value-identical to encode.c:120-144.
    Used only to derive the encode bit-matrix at construction time."""
    fs = gf.field_size
    log2exp = gf.log2exp.astype(np.int64)
    exp2log = gf.exp2log.astype(np.int64)
    B, size = data.shape
    genrev = genlog[num_roots - 1 :: -1].copy()  # genrev[l] = genlog[nr-1-l]
    parity = np.zeros((B, num_roots), dtype=np.int64)
    for i in range(size):
        fb = exp2log[(data[:, i] & fs) ^ parity[:, 0]]
        valid = (fb != fs)[:, None]
        contrib = np.where(valid, log2exp[(fb[:, None] + genrev[None, :]) % fs], 0)
        shifted = np.concatenate(
            [parity[:, 1:], np.zeros((B, 1), dtype=np.int64)], axis=1
        )
        parity = shifted ^ contrib
    return parity


from ..utils.cache import LruCache

_MATRIX_CACHE = LruCache(capacity=16)


class RSCodec:
    """Batched Reed-Solomon over GF(2^m), m <= 8 for the byte API."""

    def __init__(self, cfg: RSConfig):
        gf = GF(cfg.symbol_size, cfg.generator_polynomial)
        if cfg.primitive_element == 0:
            raise GFError("primitive_element must be nonzero (poporon.c:78-82)")
        self.gf = gf
        self.m = gf.symbol_size
        self.fs = gf.field_size
        self.poly = gf.generator_polynomial
        self.fcr = int(cfg.first_consecutive_root)
        self.prim = int(cfg.primitive_element)
        self.num_roots = int(cfg.num_roots)
        self.k = self.fs - self.num_roots  # max data symbols
        if self.k <= 0:
            raise GFError("num_roots >= field size")

        # primitive inverse by the reference's trial loop (poporon.c:84-93)
        v, it = 1, 0
        while v % self.prim != 0:
            v += self.fs
            it += 1
            if it > self.fs * 2:
                raise GFError("primitive_element has no inverse")
        self.prim_inv = v // self.prim

        self.genlog = _build_genpoly(gf, self.fcr, self.prim, self.num_roots)

        key = (self.m, gf.generator_polynomial, self.fcr, self.prim, self.num_roots)
        mats = _MATRIX_CACHE.get_or_build(key, self._build_matrices)
        (g_enc, g_syn, m_chien, m_omega, m_den,
         inv_tbl, sec_tbl, alpha_tbl) = mats

        f32 = jnp.float32
        self.G_enc = jnp.asarray(g_enc, dtype=f32)      # [k*m, nr*m]
        self.G_syn = jnp.asarray(g_syn, dtype=f32)      # [fs*m, nr*m]
        self.M_chien = jnp.asarray(m_chien, dtype=f32)  # [nr*m, fs*m]
        self.M_omega = jnp.asarray(m_omega, dtype=f32)  # [nr*m, fs*m]
        self.M_den = jnp.asarray(m_den, dtype=f32)      # [(nr+1)*m, fs*m]
        self.inv_tbl = jnp.asarray(inv_tbl, dtype=jnp.int32)    # inv[0] = 1
        self.sec_tbl = jnp.asarray(sec_tbl, dtype=jnp.int32)    # by root index
        self.alpha_tbl = jnp.asarray(alpha_tbl, dtype=jnp.int32)
        self.log2exp_j = jnp.asarray(gf.log2exp, dtype=jnp.int32)
        self.exp2log_j = jnp.asarray(gf.exp2log, dtype=jnp.int32)

    # ------------------------------------------------------------ build

    def _build_matrices(self):
        gf, m, nr, fs = self.gf, self.m, self.num_roots, self.fs
        k = self.k
        # Encode matrix: parity response of every data-bit basis vector,
        # obtained by running the (NumPy) LFSR — captures encode.c exactly.
        basis = np.zeros((k * m, k), dtype=np.int64)
        for p in range(k):
            for b in range(m):
                basis[p * m + b, p] = 1 << (m - 1 - b)
        parity = _encode_np(gf, self.genlog, nr, basis)          # [k*m, nr]
        g_enc = _symbols_to_bits_np(parity, m)                    # [k*m, nr*m]

        # Syndrome matrix: S_i = sum_j r_j alpha^{(fcr+i)*prim*(fs-1-j)}
        # over the full-length (zero-padded) word — Horner closed form of
        # decode.c:375-415.
        pos = np.arange(fs, dtype=np.int64)[:, None]              # j
        i = np.arange(nr, dtype=np.int64)[None, :]
        expnt = ((self.fcr + i) * self.prim * (fs - 1 - pos)) % fs
        g_syn = gf.linear_matrix(gf.log2exp[expnt])               # [fs*m, nr*m]

        # Chien evaluation matrix: terms(i) = sum_{j>=1} lam_j alpha^{j*i},
        # i = 1..fs (dense replacement of decode.c:115-141).
        j = np.arange(1, nr + 1, dtype=np.int64)[:, None]
        i2 = np.arange(1, fs + 1, dtype=np.int64)[None, :]
        m_chien = gf.linear_matrix(gf.log2exp[(j * i2) % fs])     # [nr*m, fs*m]

        # Omega evaluation: num_j = sum_i Omega_i alpha^{i*root_j}
        # (decode.c:160-169) at all root points r = 1..fs.
        ji = np.arange(nr, dtype=np.int64)[:, None]
        m_omega = gf.linear_matrix(gf.log2exp[(ji * i2) % fs])    # [nr*m, fs*m]

        # Denominator (formal derivative): sum_{even i} lam_{i+1}
        # alpha^{i*r} (decode.c:179-185) — rows for odd lambda indices.
        den_consts = np.zeros((nr + 1, fs), dtype=np.int64)
        for jj in range(1, nr + 1, 2):  # lambda_j with j odd, exponent (j-1)*r
            den_consts[jj] = gf.log2exp[((jj - 1) * np.arange(1, fs + 1)) % fs]
        m_den = gf.linear_matrix(den_consts)                      # [(nr+1)*m, fs*m]

        # inverse table with the reference's zero-denominator quirk:
        # den == 0 contributes alpha^{fs - exp2log[0]} = alpha^0 = 1
        # (decode.c:187-189 with the sentinel).
        inv_tbl = np.zeros(fs + 1, dtype=np.int64)
        inv_tbl[0] = 1
        for x in range(1, fs + 1):
            inv_tbl[x] = gf.log2exp[(fs - int(gf.exp2log[x])) % fs]

        # second-numerator by Chien root index r (decode.c:175-176):
        # alpha^{((r*(fcr-1) + fs) mod 2^16) mod fs} — int arithmetic then
        # uint16 truncation, matching the C.
        r = np.arange(fs + 1, dtype=np.int64)
        sec_arg = ((r * (self.fcr - 1) + fs) % 65536) % fs
        sec_tbl = gf.log2exp[sec_arg]

        alpha_tbl = gf.log2exp[np.arange(fs, dtype=np.int64)]
        return (g_enc, g_syn, m_chien, m_omega, m_den,
                inv_tbl, sec_tbl, alpha_tbl)

    # ----------------------------------------------------------- encode

    @functools.partial(jax.jit, static_argnums=0)
    def _encode(self, data):
        m, fs = self.m, self.fs
        size = data.shape[-1]
        data = data.astype(jnp.int32) & fs
        bits = _symbols_to_bits(data, m).astype(jnp.float32)
        g = self.G_enc[(self.k - size) * m :]  # shortened: suffix rows
        pbits = gf2_matmul(bits, g)
        return _bits_to_symbols(pbits, m).astype(jnp.uint8)

    def encode(self, data):
        """data: uint8 [B, size] (or [size]) -> parity uint8 [B, nr]."""
        data = jnp.asarray(data)
        squeeze = data.ndim == 1
        if squeeze:
            data = data[None]
        if data.shape[-1] > self.k:
            raise ValueError(f"size {data.shape[-1]} exceeds k={self.k}")
        out = self._encode(data)
        return out[0] if squeeze else out

    # ------------------------------------------------------- decode core

    def _gf_mul(self, a, b):
        return gf_mul(a, b, self.m, self.poly)

    def _syndrome(self, data, parity):
        """Normal-domain syndromes [B, nr] of the shortened word."""
        m, fs = self.m, self.fs
        size = data.shape[-1]
        pad = fs - self.num_roots - size
        dbits = _symbols_to_bits(data.astype(jnp.int32) & fs, m)
        pbits = _symbols_to_bits(parity.astype(jnp.int32) & fs, m)
        gd = self.G_syn[pad * m : (pad + size) * m]
        gp = self.G_syn[(pad + size) * m :]
        sbits = gf2_matmul(dbits.astype(jnp.float32), gd) ^ gf2_matmul(
            pbits.astype(jnp.float32), gp
        )
        return _bits_to_symbols(sbits, m)

    def _erasure_locator(self, eras_pos, eras_count, pad):
        """Batched erasure-locator product (decode.c:34-47), normal domain.

        eras_pos: [B, E] int32 positions; eras_count: [B] int32.
        Returns error_locator [B, nr+1].
        """
        B, E = eras_pos.shape
        fs, nr = self.fs, self.num_roots
        # term_i = alpha^{(prim*(fs-1-(pos+pad)) mod 2^16) mod fs}
        raw = self.prim * (fs - 1 - (eras_pos + pad))
        terms = table_select(self.alpha_tbl, (raw & 0xFFFF) % fs)  # [B, E]

        el = jnp.zeros((B, nr + 1), dtype=jnp.int32)
        el = el.at[:, 0].set(1)
        el = el.at[:, 1].set(jnp.where(eras_count > 0, terms[:, 0], 0))

        lane = jnp.arange(nr + 1, dtype=jnp.int32)[None, :]

        def body(i, el):
            active = (i < eras_count)[:, None]
            term_i = jax.lax.dynamic_slice(terms, (0, i), (B, 1))
            el_shift = jnp.roll(el, 1, axis=1).at[:, 0].set(0)   # el[j-1]
            contrib = self._gf_mul(term_i, el_shift)
            maskj = (lane >= 1) & (lane <= i + 1)
            return el ^ jnp.where(active & maskj, contrib, 0)

        if E > 1:
            el = jax.lax.fori_loop(1, E, body, el)
        return el

    def _bm_planes(self, s_cm, el0_cm, eras_count, no_erasures: bool):
        """Fixed-trip branchless BM (decode.c:49-96), fully bit-sliced.

        The per-iteration GF products (discrepancy, locator update,
        b-poly rescale, inversion) run on batch-packed bit planes
        (ops/gfbit.py): ~10x fewer elementwise ops and 4x less memory
        traffic than the packed-int form.  Control flow stays packed too: poly_deg
        lives as an 8-bit-sliced integer ([8, W] planes) and the grow
        condition / updates use ripple compare/add/sub circuits
        (gfbit.u_le/u_add/u_sub) — the loop body never touches an
        unpacked [B] tensor.

        s_cm:   [nr, m, W] syndrome planes (coeff-major).
        el0_cm: [nr+1, m, W] initial locator planes.
        eras_count: [B] int32 (ignored when no_erasures).
        Returns error-locator planes [nr+1, m, W].
        """
        m, poly, nr = self.m, self.poly, self.num_roots
        W = s_cm.shape[-1]
        PD_BITS = 8  # poly_deg and it+ec fit in 8 bits for nr <= 127
        zero_row = jnp.zeros((1, m, W), dtype=gfbit.U32)
        # window buffer: at iteration it, v_j = S[it-1-j] for j < it
        sbuf = jnp.concatenate(
            [s_cm[::-1], jnp.zeros((nr + 1, m, W), dtype=gfbit.U32)], axis=0
        )
        lane = jnp.arange(nr + 1, dtype=jnp.int32)[:, None, None]

        if not no_erasures:
            ec_p = gfbit.pack_planes(eras_count.astype(jnp.int32), PD_BITS)

        def body(it, state):
            el, bpoly, pd = state
            v = jax.lax.dynamic_slice(sbuf, (nr - it, 0, 0), (nr + 1, m, W))
            v = jnp.where(lane < it, v, gfbit.U32(0))
            disc = gfbit.xor_reduce(gfbit.mul(el, v, m, poly), 0)  # [m, W]
            disc_nz_w = gfbit.nonzero_mask(disc[None])[0]          # [W]

            xb = jnp.concatenate([zero_row, bpoly[:-1]], axis=0)   # b * x
            # disc == 0 makes the product vanish, so this IS the
            # "keep el" branch of the reference
            new_el = el ^ gfbit.mul(disc[None], xb, m, poly)

            # grow condition 2*pd <= it + ec - 1 on packed planes
            if no_erasures:
                rhs = gfbit.u_broadcast(it - 1, PD_BITS, W)
                it_ec = gfbit.u_broadcast(it, PD_BITS, W)
            else:
                it_p = gfbit.u_broadcast(it, PD_BITS, W)
                it_ec = gfbit.u_add(it_p, ec_p)
                rhs = gfbit.u_sub(
                    it_ec, gfbit.u_broadcast(1, PD_BITS, W)
                )
            pd2 = jnp.concatenate([pd[:1] & 0, pd[:-1]], axis=0)   # 2*pd
            grow_w = gfbit.u_le(pd2, rhs) & disc_nz_w              # [W]

            disc_inv = gfbit.inv(disc[None], m, poly)              # [1, m, W]
            b_grow = gfbit.mul(el, disc_inv, m, poly)

            new_b = gfbit.select(grow_w, b_grow, xb)
            new_pd = gfbit.select(grow_w, gfbit.u_sub(it_ec, pd), pd)
            return new_el, new_b, new_pd

        def outer(it, state):
            el, bpoly, pd = state
            new = body(it, state)
            # active: it > ec  <=>  NOT (it <= ec)
            it_p = gfbit.u_broadcast(it, PD_BITS, W)
            active_w = ~gfbit.u_le(it_p, ec_p)
            return (
                gfbit.select(active_w, new[0], el),
                gfbit.select(active_w, new[1], bpoly),
                gfbit.select(active_w, new[2], pd),
            )

        pd0 = (
            jnp.broadcast_to(s_cm[0, :1] & gfbit.U32(0), (PD_BITS, W))
            if no_erasures else ec_p
        )
        state = (el0_cm, el0_cm, pd0)
        step = body if no_erasures else outer
        el, _, _ = jax.lax.fori_loop(1, nr + 1, step, state)
        return el

    # Unroll budget for the omega convolution: below this the nr+1-term
    # loop is emitted inline (XLA fuses the whole convolution); above
    # it the unroll would dominate compile time (~19k HLO ops at
    # nr=127), so it runs as a fori_loop instead.
    _OMEGA_UNROLL_MAX = 48

    def _omega_planes(self, el_cm, s_cm):
        """Omega = S * lambda mod x^nr (decode.c:147-158), bit-sliced.

        Polynomial convolution over coeff-major planes:
        omega_i = XOR_j el_j * S_{i-j}.  el_cm [nr+1, m, W];
        s_cm [nr, m, W].  Returns [nr, m, W]."""
        m, poly, nr = self.m, self.poly, self.num_roots
        W = s_cm.shape[-1]
        spad = jnp.concatenate(
            [jnp.zeros((nr, m, W), dtype=gfbit.U32), s_cm], axis=0
        )                                                          # [2nr, m, W]
        if nr <= self._OMEGA_UNROLL_MAX:
            acc = None
            for j in range(nr + 1):
                term = gfbit.mul(
                    el_cm[j : j + 1], spad[nr - j : 2 * nr - j], m, poly
                )
                acc = term if acc is None else acc ^ term
            return acc

        def body(j, acc):
            ej = jax.lax.dynamic_slice(el_cm, (j, 0, 0), (1, m, W))
            sj = jax.lax.dynamic_slice(spad, (nr - j, 0, 0), (nr, m, W))
            return acc ^ gfbit.mul(ej, sj, m, poly)

        acc0 = jnp.zeros((nr, m, W), dtype=gfbit.U32)
        return jax.lax.fori_loop(0, nr + 1, body, acc0)

    def _eval_at_all_points(self, coeffs, matrix):
        """GF(2)-linear evaluation of per-element polynomials at all fs
        field points: coeffs [B, C] -> values [B, fs]."""
        bits = _symbols_to_bits(coeffs, self.m).astype(jnp.float32)
        out_bits = gf2_matmul(bits, matrix)
        return _bits_to_symbols(out_bits, self.m)

    def _correct(self, data, parity, s_norm, eras_pos, eras_count, pad,
                 erasure_apply: bool, no_erasures: bool = False):
        """error_correction_u8 (decode.c:17-230), batched, gather-free.

        no_erasures (static): plain/external-syndrome paths skip the
        erasure-locator product and BM's per-element start masking
        entirely (the C passes NULL erasures there, decode.c:475-477).
        Returns (ok [B] bool, data, parity, corrected [B] int32).
        """
        B, size = data.shape
        fs, nr, m = self.fs, self.num_roots, self.m
        t_max = nr

        s_cm = gfbit.pack_planes(s_norm.T, m)                     # [nr, m, W]
        if no_erasures:
            W = s_cm.shape[-1]
            # derive from a varying input (s_cm & 0) so the BM loop
            # carry type is stable under shard_map manual axes
            el0_cm = (
                jnp.broadcast_to(s_cm[:1] & gfbit.U32(0), (nr + 1, m, W))
                .at[0, 0].set(gfbit.U32(0xFFFFFFFF))              # lambda = 1
            )
        else:
            el0 = self._erasure_locator(eras_pos, eras_count, pad)
            el0_cm = gfbit.pack_planes(el0.T, m)
        el_cm = self._bm_planes(s_cm, el0_cm, eras_count, no_erasures)
        omega_all = gfbit.unpack_planes(
            self._omega_planes(el_cm, s_cm), B
        ).T                                                       # [B, nr]
        el = gfbit.unpack_planes(el_cm, B).T                      # [B, nr+1]

        lane = jnp.arange(nr + 1, dtype=jnp.int32)[None, :]
        deg = jnp.max(jnp.where(el != 0, lane, 0), axis=1)        # [B]
        fail_deg = deg == 0

        # --- Chien: roots at alpha^i, i = 1..fs (dense) ---
        terms = self._eval_at_all_points(el[:, 1:], self.M_chien)  # [B, fs]
        root_mask = terms == 1                                     # eval == 0
        i_vals = jnp.arange(1, fs + 1, dtype=jnp.int32)[None, :]
        cum = jnp.cumsum(root_mask.astype(jnp.int32), axis=1)
        selected = root_mask & (cum <= deg[:, None])
        found = jnp.sum(selected.astype(jnp.int32), axis=1)
        k_vals = (i_vals * self.prim_inv - 1) % fs
        fail_pad = jnp.any(selected & (k_vals < pad), axis=1)
        fail_count = found != deg

        jlane = jnp.arange(t_max, dtype=jnp.int32)[None, :]
        jvalid = jlane < deg[:, None]
        iv = jnp.broadcast_to(i_vals, (B, fs))
        roots = onehot_select(
            jnp.where(selected, iv, 0), selected, t_max
        ).astype(jnp.int32)                                        # [B, t]
        roots = jnp.where(jvalid, roots, 0)
        locs = jnp.where(jvalid, (roots * self.prim_inv - 1) % fs, 0)

        # --- Omega = S * lambda mod x^nr, entries masked to < deg
        # (decode.c:147-158); the convolution itself ran bit-sliced
        # above (_omega_planes) ---
        ii = jnp.arange(nr, dtype=jnp.int32)[None, :]
        omega = jnp.where(ii <= deg[:, None] - 1, omega_all, 0)

        # --- Forney (decode.c:160-191): evaluate at all points, compact
        # per-root with one-hot einsums ---
        omega_evals = self._eval_at_all_points(omega, self.M_omega)   # [B, fs]
        den_evals = self._eval_at_all_points(el, self.M_den)          # [B, fs]
        numerator = onehot_select(
            jnp.where(selected, omega_evals, 0), selected, t_max
        ).astype(jnp.int32)
        denominator = onehot_select(
            jnp.where(selected, den_evals, 0), selected, t_max
        ).astype(jnp.int32)
        second = table_select(self.sec_tbl, roots)                    # [B, t]

        coeff = self._gf_mul(
            self._gf_mul(numerator, second),
            table_select(self.inv_tbl, denominator),
        )
        live = jvalid & (numerator != 0)
        coeff = jnp.where(live, coeff, 0)
        corrected = jnp.sum(live.astype(jnp.int32), axis=1)

        # --- syndrome re-verification (decode.c:193-209): syndromes of
        # the correction vector must equal the original syndromes ---
        corr_vec = scatter_mod2(
            coeff, jnp.where(jvalid, locs, -1), fs
        ).astype(jnp.int32)                                           # [B, fs]
        vbits = gf2_matmul(
            _symbols_to_bits(corr_vec, m).astype(jnp.float32), self.G_syn
        )
        v = _bits_to_symbols(vbits, m)
        fail_verify = jnp.any(v != s_norm, axis=1)

        # --- apply corrections ---
        if erasure_apply:
            # decode.c:211-214: XOR coeff_j at the user's erasure positions
            E = eras_pos.shape[1]
            posj = jnp.pad(eras_pos, ((0, 0), (0, max(0, t_max - E))))[:, :t_max]
            posj = jnp.where(jvalid, posj, -1)
            vec = scatter_mod2(coeff, posj, size).astype(jnp.int32)
            data_out = data.astype(jnp.int32) ^ vec
            parity_out = parity.astype(jnp.int32)
            fail_apply = jnp.zeros((B,), dtype=bool)
        else:
            loc_pad = locs - pad
            in_data = (loc_pad >= 0) & (loc_pad < size) & jvalid
            in_parity = (loc_pad >= size) & (loc_pad < size + nr) & jvalid
            bad = jvalid & ~(in_data | in_parity)
            fail_apply = jnp.any(bad, axis=1)
            # C applies sequentially and stops at the first bad location
            first_bad = jnp.min(jnp.where(bad, jlane, t_max), axis=1)
            app = jvalid & (jlane < first_bad[:, None])
            cval = jnp.where(app, coeff, 0)
            dvec = scatter_mod2(
                cval, jnp.where(in_data & app, loc_pad, -1), size
            ).astype(jnp.int32)
            pvec = scatter_mod2(
                cval, jnp.where(in_parity & app, loc_pad - size, -1), nr
            ).astype(jnp.int32)
            data_out = data.astype(jnp.int32) ^ dvec
            parity_out = parity.astype(jnp.int32) ^ pvec

        fail_pre = fail_deg | fail_pad | fail_count
        ok = ~(fail_pre | fail_verify | fail_apply)
        corrected = jnp.where(fail_pre, 0, corrected)
        # on any failure the reference leaves data untouched EXCEPT the
        # partial-application quirk, which `app` above already encodes for
        # fail_apply; for all other failures revert.
        revert = (fail_pre | fail_verify)[:, None]
        data_out = jnp.where(revert, data.astype(jnp.int32), data_out)
        parity_out = jnp.where(revert, parity.astype(jnp.int32), parity_out)
        return ok, data_out.astype(jnp.uint8), parity_out.astype(jnp.uint8), corrected

    # ------------------------------------------------------ decode paths

    def _finish(self, has_err, data, parity, ok_c, d, p, corr):
        ok = jnp.where(has_err, ok_c, True)
        keep = ~has_err
        d = jnp.where(keep[:, None], data, d)
        p = jnp.where(keep[:, None], parity, p)
        corr = jnp.where(keep, 0, corr)
        return ok, d, p, corr

    @functools.partial(jax.jit, static_argnums=0)
    def _decode_plain(self, data, parity):
        B, size = data.shape
        pad = self.fs - self.num_roots - size
        s = self._syndrome(data, parity)
        has_err = jnp.any(s != 0, axis=1)
        zero_pos = jnp.zeros((B, 1), dtype=jnp.int32)
        zero_cnt = jnp.zeros((B,), dtype=jnp.int32)
        out = self._correct(data, parity, s, zero_pos, zero_cnt, pad, False,
                            no_erasures=True)
        return self._finish(has_err, data, parity, *out)

    @functools.partial(jax.jit, static_argnums=0)
    def _decode_erasure(self, data, parity, eras_pos, eras_count):
        B, size = data.shape
        pad = self.fs - self.num_roots - size
        s = self._syndrome(data, parity)
        has_err = jnp.any(s != 0, axis=1)
        out = self._correct(data, parity, s, eras_pos, eras_count, pad, True)
        return self._finish(has_err, data, parity, *out)

    @functools.partial(jax.jit, static_argnums=0)
    def _decode_ext_syndrome(self, data, parity, s_log):
        """External log-form syndromes (decode.c:446-464): sentinel fs =
        "no error"; converted once to normal domain."""
        B, size = data.shape
        pad = self.fs - self.num_roots - size
        has_err = jnp.any(s_log != self.fs, axis=1)
        s_norm = table_select(self.log2exp_j, s_log)
        zero_pos = jnp.zeros((B, 1), dtype=jnp.int32)
        zero_cnt = jnp.zeros((B,), dtype=jnp.int32)
        out = self._correct(data, parity, s_norm, zero_pos, zero_cnt, pad,
                            False, no_erasures=True)
        return self._finish(has_err, data, parity, *out)

    def decode(self, data, parity, erasures=None, ext_syndrome=None):
        """Batched decode.

        data [B, size] / [size] uint8; parity [B, nr] / [nr].
        erasures: optional (positions [B, E], counts [B]) int32 arrays, or
        a 1-D position list broadcast over the batch.
        ext_syndrome: optional log-form syndromes [B, nr] (sentinel fs =
        "no error"), the external-syndrome path of decode.c:446-464.

        Returns (ok [B] bool, data, parity, corrected [B] int32).
        """
        data = jnp.asarray(data)
        parity = jnp.asarray(parity)
        squeeze = data.ndim == 1
        if squeeze:
            data = data[None]
            parity = parity[None]
        size = data.shape[-1]
        pad = self.fs - self.num_roots - size
        if pad < 0 or pad >= self.fs - self.num_roots:
            B = data.shape[0]
            z = jnp.zeros((B,), dtype=jnp.int32)
            out = (jnp.zeros((B,), bool), data, parity, z)
            return tuple(o[0] for o in out) if squeeze else out

        if ext_syndrome is not None:
            s = jnp.asarray(ext_syndrome, dtype=jnp.int32)
            if s.ndim == 1:
                s = jnp.broadcast_to(s[None], (data.shape[0], self.num_roots))
            out = self._decode_ext_syndrome(data, parity, s)
        elif erasures is not None:
            if isinstance(erasures, tuple):
                pos, cnt = erasures
            else:
                pos = jnp.asarray(erasures, dtype=jnp.int32)
                if pos.ndim == 1:
                    pos = jnp.broadcast_to(pos[None], (data.shape[0], pos.shape[0]))
                cnt = jnp.full((data.shape[0],), pos.shape[1], dtype=jnp.int32)
            pos = jnp.asarray(pos, dtype=jnp.int32)
            cnt = jnp.asarray(cnt, dtype=jnp.int32)
            out = self._decode_erasure(data, parity, pos, cnt)
        else:
            out = self._decode_plain(data, parity)
        if squeeze:
            return tuple(o[0] for o in out)
        return out
