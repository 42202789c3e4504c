"""Binary BCH codec, batched on the accelerator.

Re-design of the reference BCH implementation (src/bch.c) for batched
execution: the reference processes one <=31-bit codeword per call with
bit loops; here a whole uint32 batch is decoded at once.

* Generator construction (LCM of minimal polynomials over conjugacy
  classes, bch.c:168-286) is host-side Python, bit-exact.
* Encoding (polynomial long division, bch.c:352-380) is GF(2)-linear in
  the data bits -> precomputed remainder matrix, one matmul mod 2.
* Syndromes (bch.c:25-51) are GF(2)-linear in the received bits ->
  matmul mod 2 against a [n, 2t*m] constant matrix.
* Berlekamp-Massey (bch.c:78-142) runs as a fixed 2t-trip batched loop
  with branchless selects.
* Chien search (bch.c:144-166) evaluates the locator at all n points
  with one matmul (coefficients masked to degree error_count, matching
  bch_poly_eval's explicit degree bound).

Word sizes: the reference packs codewords in a uint32, so its support
matrix's BCH(63,51) row (README.md:427) is undefined behavior in C —
n=63 does not fit, and the byte wrappers shift a uint32 by >=32 bits
(encode.c:215, decode.c:561).  Here the canonical device representation
is an LSB-first bit tensor [B, n], which is well-defined for every
m in [3, 16]; the int32 word API is kept as an adapter for n <= 31.
Bit-exactness vs the reference is oracle-tested for m <= 5; m >= 6 has
no well-defined C behavior to compare against and is spec-level tested
(t errors corrected, t+1 rejected, byte round-trip) at m = 6
(test_bch63.py) and m = 7 / 10 / 12 (test_bch_large.py), covering the
constructor's accepted range.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BchConfig
from ..ops.gf import GF, GFError
from ..ops.gf2 import gf2_matmul
from ..ops.gfint import gf_mul, table_select
from .rs import _xor_reduce, _symbols_to_bits, _bits_to_symbols

_BCH_MAX_POLY = 64
_BCH_MAX_T = 16


def _min_poly(gf: GF, exp: int) -> int:
    """Binary minimal polynomial of alpha^exp (bch.c:168-207)."""
    fs = gf.field_size
    poly = [0] * _BCH_MAX_POLY
    poly[0] = 1
    deg = 0
    conj = exp
    while True:
        root = int(gf.log2exp[conj])
        for j in range(deg, -1, -1):
            if j + 1 < _BCH_MAX_POLY:
                poly[j + 1] ^= poly[j]
            if poly[j] != 0 and root != 0:
                lp = (int(gf.exp2log[poly[j]]) + int(gf.exp2log[root])) % fs
                poly[j] = int(gf.log2exp[lp])
            else:
                poly[j] = 0
        deg += 1
        conj = (conj * 2) % fs
        if conj == exp:
            break
    out = 0
    for i in range(deg + 1):
        if poly[i] == 1:
            out |= 1 << i
    return out


def _poly_deg(p: int) -> int:
    return p.bit_length() - 1 if p else -1


class BCHCodec:
    """Batched binary BCH over GF(2^m), codewords as integer words."""

    def __init__(self, cfg: BchConfig):
        if cfg.symbol_size < 3 or cfg.symbol_size > 16:
            raise GFError("BCH symbol_size must be in [3, 16] (bch.c:293)")
        if not (1 <= cfg.correction_capability <= _BCH_MAX_T):
            raise GFError("BCH t must be in [1, 16] (bch.c:297)")
        gf = GF(cfg.symbol_size, cfg.generator_polynomial)
        self.gf = gf
        self.m = gf.symbol_size
        self.fs = gf.field_size
        self.t = int(cfg.correction_capability)
        self.n = (1 << self.m) - 1  # codeword_length

        # generator = LCM of minimal polys of alpha^1..alpha^2t (bch.c:241-286)
        used = [False] * (self.fs + 1)
        gen, gen_deg = 1, 0
        for i in range(1, 2 * self.t + 1):
            r = i % self.fs
            if used[r]:
                continue
            c = r
            while True:
                used[c] = True
                c = (c * 2) % self.fs
                if c == r:
                    break
            mp = _min_poly(gf, r)
            # binary polynomial multiply
            acc = 0
            a = gen
            sh = 0
            while a:
                if a & 1:
                    acc ^= mp << sh
                a >>= 1
                sh += 1
            gen = acc
            gen_deg = _poly_deg(gen)
        self.gen_poly = gen
        self.gen_poly_deg = gen_deg
        self.parity_bits = gen_deg
        self.data_length = self.n - self.parity_bits

        self._build_matrices()

    # ------------------------------------------------------------ build

    def _encode_word(self, data: int) -> int:
        """Scalar long-division encoder (bch.c:352-380 semantics)."""
        shifted = data << self.parity_bits
        rem = shifted
        for i in range(self.n - 1, self.gen_poly_deg - 1, -1):
            if rem & (1 << i):
                rem ^= self.gen_poly << (i - self.gen_poly_deg)
        return shifted ^ rem

    def _build_matrices(self):
        gf, m, n, t = self.gf, self.m, self.n, self.t
        fs = self.fs
        # Remainder matrix: parity bits of each data-bit basis vector.
        R = np.zeros((self.data_length, self.parity_bits), dtype=np.uint8)
        pmask = (1 << self.parity_bits) - 1
        for i in range(self.data_length):
            cw = self._encode_word(1 << i)
            p = cw & pmask
            for b in range(self.parity_bits):
                R[i, b] = (p >> b) & 1  # LSB-first parity bit order
        self.R_enc = jnp.asarray(R, dtype=jnp.float32)

        # Syndrome constants: S_i ^= log2exp[((i+1)*j) % fs] for set bit j
        j = np.arange(n, dtype=np.int32)[:, None]
        i = np.arange(2 * t, dtype=np.int32)[None, :]
        syn_consts = gf.log2exp[((i + 1) * j) % fs]           # [n, 2t]
        self.G_syn = jnp.asarray(gf.linear_matrix_bits_in(syn_consts), dtype=jnp.float32)

        # Chien constants: eval at x = alpha^{(fs - i) % fs}, i = 0..n-1:
        # term_{c,i} = lambda_c * alpha^{(c * (fs - i)) % fs}
        c = np.arange(_BCH_MAX_POLY, dtype=np.int32)[:, None]
        ii = np.arange(n, dtype=np.int32)[None, :]
        logx = (fs - ii) % fs
        chien_consts = gf.log2exp[(c * logx) % fs % fs]       # [64, n]
        self.M_chien = jnp.asarray(gf.linear_matrix(chien_consts), dtype=jnp.float32)

        self.log2exp_j = jnp.asarray(gf.log2exp, dtype=jnp.int32)
        self.exp2log_j = jnp.asarray(gf.exp2log, dtype=jnp.int32)

        inv = np.zeros(fs + 1, dtype=np.int64)
        for x in range(1, fs + 1):
            inv[x] = gf.log2exp[(fs - int(gf.exp2log[x])) % fs]
        self.inv_tbl = jnp.asarray(inv, dtype=jnp.int32)

    # --------------------------------------------------- bit-tensor codec
    #
    # Canonical representation: LSB-first codeword bits [B, n] int32
    # (bit j = coefficient of x^j), well-defined for every m.  The C
    # word layout cw = (data << parity_bits) | parity maps to
    # bits[:parity_bits] = parity, bits[parity_bits:] = data.

    def _word_bits(self, w):
        """int word [B] -> LSB-first bits [B, n] (n <= 31 only)."""
        shifts = jnp.arange(self.n, dtype=jnp.int32)
        return ((w.astype(jnp.int32)[:, None] >> shifts) & 1).astype(jnp.int32)

    def _bits_word(self, bits):
        """LSB-first bits [B, n] -> int32 word [B] (n <= 31 only)."""
        w = jnp.left_shift(jnp.int32(1), jnp.arange(self.n, dtype=jnp.int32))
        return (bits.astype(jnp.int32) * w).sum(axis=1)

    @functools.partial(jax.jit, static_argnums=0)
    def _encode_bits(self, data_bits):
        """data bits [B, data_length] LSB-first -> codeword bits [B, n]."""
        bits = data_bits.astype(jnp.float32)
        pbits = gf2_matmul(bits, self.R_enc).astype(jnp.int32)  # [B, parity]
        return jnp.concatenate([pbits, data_bits.astype(jnp.int32)], axis=1)

    def encode_bits(self, data_bits):
        """Batched bit encode: [B, data_length] -> [B, n] (all m)."""
        return self._encode_bits(jnp.asarray(data_bits))

    def encode(self, data):
        """Batched word encode; returns (ok [B], codeword [B] int32).

        Word adapter for n <= 31; use encode_bits for m = 6 (n = 63),
        where a 63-bit codeword cannot live in an int32 lane.
        """
        if self.n > 31:
            raise GFError(
                "BCH word API is limited to n <= 31; use encode_bits / "
                "the byte facade for m = 6 (reference uint32 packing is "
                "UB there, encode.c:215)"
            )
        data = jnp.asarray(data)
        squeeze = data.ndim == 0
        if squeeze:
            data = data[None]
        ok = data.astype(jnp.int32) < (1 << self.data_length)
        shifts = jnp.arange(self.data_length, dtype=jnp.int32)
        dbits = (data.astype(jnp.int32)[:, None] >> shifts) & 1
        cw = self._bits_word(self._encode_bits(dbits))
        cw = jnp.where(ok, cw, 0)
        return (ok[0], cw[0]) if squeeze else (ok, cw)

    def _syndromes(self, bits):
        """[B, n] bits -> normal-domain syndromes [B, 2t]."""
        sbits = gf2_matmul(bits.astype(jnp.float32), self.G_syn)
        return _bits_to_symbols(sbits, self.m)

    def _berlekamp_massey(self, S):
        """bch.c:78-142, batched, gather-free normal-domain arithmetic.

        S: [B, 2t] normal-domain syndromes.
        Returns (error_locator [B, 64], error_count [B]).
        """
        B = S.shape[0]
        fs = self.fs
        P = _BCH_MAX_POLY
        t2 = 2 * self.t
        lane = jnp.arange(P, dtype=jnp.int32)[None, :]

        # window buffer: at iteration it, w_j = S[it-j] for 0 <= j <= it
        sbuf = jnp.concatenate([S[:, ::-1], jnp.zeros((B, P), jnp.int32)], axis=1)

        # derive the initial state from a varying input (S * 0) so the
        # loop carry type is stable under shard_map manual axes
        zcol = S[:, :1] & 0                                    # [B, 1] zeros
        current = jnp.broadcast_to(zcol, (B, P)).at[:, 0].set(1)
        prev = current
        ec = zcol[:, 0]
        shift = zcol[:, 0] + 1
        prev_disc = zcol[:, 0] + 1

        def mul(a, b):
            return gf_mul(a, b, self.m, self.gf.generator_polynomial)

        def body(it, state):
            current, prev, ec, shift, prev_disc = state
            # discrepancy = S[it] ^ sum_{1<=i<=ec} current_i * S[it-i]
            # (bch.c:98-105)
            w = jax.lax.dynamic_slice(sbuf, (0, t2 - 1 - it), (B, P))
            w = jnp.where(lane <= it, w, 0)
            valid = (lane >= 1) & (lane <= ec[:, None])
            disc = _xor_reduce(jnp.where(valid, mul(current, w), 0), 1)
            s_it = w[:, 0]
            disc = s_it ^ disc

            no_disc = disc == 0
            # multiplier = disc / prev_disc (bch.c:110-111); prev_disc != 0
            multiplier = mul(disc, table_select(self.inv_tbl, prev_disc))
            # current[i+shift] ^= prev[i] * multiplier — per-element shift
            # realised as a masked sum of static shifts (shift <= 2t+1)
            contrib = mul(prev, multiplier[:, None])
            upd = jnp.zeros((B, P), jnp.int32)
            for s in range(1, t2 + 2):
                sh = jnp.concatenate(
                    [jnp.zeros((B, s), jnp.int32), contrib[:, : P - s]], axis=1
                )
                upd = upd ^ jnp.where((shift == s)[:, None], sh, 0)
            new_current = current ^ upd
            grow = 2 * ec <= it

            current2 = jnp.where(no_disc[:, None], current, new_current)
            prev2 = jnp.where((no_disc | ~grow)[:, None], prev, current)
            ec2 = jnp.where(no_disc | ~grow, ec, it + 1 - ec)
            prev_disc2 = jnp.where(no_disc | ~grow, prev_disc, disc)
            shift2 = jnp.where(no_disc, shift + 1, jnp.where(grow, 1, shift + 1))
            return current2, prev2, ec2, shift2, prev_disc2

        current, prev, ec, shift, prev_disc = jax.lax.fori_loop(
            0, t2, body, (current, prev, ec, shift, prev_disc)
        )
        return current, ec

    @functools.partial(jax.jit, static_argnums=0)
    def _decode_bits(self, bits):
        """received bits [B, n] -> (ok, corrected bits, num_errors)."""
        bits = bits.astype(jnp.int32)
        S = self._syndromes(bits)
        clean = ~jnp.any(S != 0, axis=1)

        locator, ec = self._berlekamp_massey(S)
        fail_t = ec > self.t

        # Chien: mask coefficients to degree ec (bch_poly_eval degree arg)
        lane = jnp.arange(_BCH_MAX_POLY, dtype=jnp.int32)[None, :]
        lam = jnp.where(lane <= ec[:, None], locator, 0)
        lam_bits = _symbols_to_bits(lam, self.m).astype(jnp.float32)
        ev_bits = gf2_matmul(lam_bits, self.M_chien)
        evals = _bits_to_symbols(ev_bits, self.m)              # [B, n]
        root_mask = evals == 0
        cum = jnp.cumsum(root_mask.astype(jnp.int32), axis=1)
        selected = root_mask & (cum <= ec[:, None])
        found = selected.astype(jnp.int32).sum(axis=1)
        fail_found = found != ec

        corrected = bits ^ selected.astype(jnp.int32)

        S2 = self._syndromes(corrected)
        fail_verify = jnp.any(S2 != 0, axis=1)

        ok = clean | ~(fail_t | fail_found | fail_verify)
        num_errors = jnp.where(clean, 0, jnp.where(ok, found, 0))
        out = jnp.where((clean | ~ok)[:, None], bits, corrected)
        return ok, out, num_errors

    def decode_bits(self, received_bits):
        """Batched bit decode: [B, n] -> (ok, corrected bits, num_errors)."""
        return self._decode_bits(jnp.asarray(received_bits))

    def decode(self, received):
        """Batched word decode -> (ok [B], corrected [B], num_errors [B]).

        Word adapter for n <= 31; use decode_bits for m = 6."""
        if self.n > 31:
            raise GFError(
                "BCH word API is limited to n <= 31; use decode_bits / "
                "the byte facade for m = 6"
            )
        received = jnp.asarray(received)
        squeeze = received.ndim == 0
        if squeeze:
            received = received[None]
        mask_n = (1 << self.n) - 1
        received = received.astype(jnp.int32) & mask_n
        ok, out, ne = self._decode_bits(self._word_bits(received))
        cw = self._bits_word(out)
        return (ok[0], cw[0], ne[0]) if squeeze else (ok, cw, ne)

    def extract_data(self, codeword):
        """bch.c:437-444 (n <= 31 word form)."""
        cw = jnp.asarray(codeword).astype(jnp.int32)
        return (cw >> self.parity_bits) & ((1 << self.data_length) - 1)

    # ------------------------------------------------ facade byte layer

    @property
    def data_bytes(self) -> int:
        return (self.data_length + 7) // 8

    @property
    def parity_bytes(self) -> int:
        return (self.parity_bits + 7) // 8

    # Byte <-> bit packing, big-endian bytes, value masked to `length`
    # bits (encode.c:215-221 / decode.c:559-575 semantics).  The C
    # loops clamp at 4 bytes because the value lives in a uint32; the
    # bit form below is the same mapping without the clamp, so it is
    # identical for n <= 31 and well-defined for m = 6.

    @staticmethod
    def _bytes_to_bits(bs, length):
        """uint8 [..., nb] big-endian -> LSB-first bits [..., length]."""
        bs = jnp.asarray(bs).astype(jnp.int32)
        nb = bs.shape[-1]
        j = jnp.arange(length, dtype=jnp.int32)
        byte_of = nb - 1 - j // 8
        shift_of = j % 8
        return (jnp.take(bs, byte_of, axis=-1) >> shift_of) & 1

    @staticmethod
    def _bits_to_bytes(bits, length, nbytes):
        """LSB-first bits [..., length] -> big-endian uint8 [..., nbytes]."""
        bits = jnp.asarray(bits).astype(jnp.int32)
        pad = nbytes * 8 - length
        if pad:
            bits = jnp.concatenate(
                [bits, jnp.zeros(bits.shape[:-1] + (pad,), jnp.int32)], axis=-1
            )
        # byte i holds bits [8*(nbytes-1-i), 8*(nbytes-1-i)+8), LSB-first
        b = bits.reshape(bits.shape[:-1] + (nbytes, 8))
        w = jnp.left_shift(jnp.int32(1), jnp.arange(8, dtype=jnp.int32))
        return (b * w).sum(axis=-1)[..., ::-1].astype(jnp.uint8)

    def pack_data(self, data):
        """uint8 [B, data_bytes] -> data bits [B, data_length]."""
        return self._bytes_to_bits(
            jnp.asarray(data)[..., : self.data_bytes], self.data_length
        )

    def unpack_data(self, bits):
        """data bits [B, data_length] -> uint8 [B, data_bytes]."""
        return self._bits_to_bytes(bits, self.data_length, self.data_bytes)

    def pack_parity(self, parity):
        """uint8 [B, parity_bytes] -> parity bits [B, parity_bits]."""
        return self._bytes_to_bits(
            jnp.asarray(parity)[..., : self.parity_bytes], self.parity_bits
        )

    def unpack_parity(self, bits):
        """parity bits [B, parity_bits] -> uint8 [B, parity_bytes]."""
        return self._bits_to_bytes(bits, self.parity_bits, self.parity_bytes)
