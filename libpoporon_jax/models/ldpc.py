"""LDPC codec, batched on the accelerator.

Re-design of the reference LDPC implementation (src/ldpc.c) for batched
execution under XLA:

* All *structure* (parity-check matrix, interleavers) is built once on
  the host, bit-exact with the reference — including the seeded
  xoshiro draw order, the double count/fill RNG pass
  (ldpc.c:310-355), the dual-diagonal staircase parity part
  (ldpc.c:357-368), the QC lifting rules (ldpc.c:425-436) and the
  Fisher-Yates interleavers (ldpc.c:150-281).

* The min-sum belief-propagation decoder (ldpc.c:693-778) runs as a
  batched jitted loop over DENSE padded layouts instead of per-edge
  scalar loops: variable-to-check messages live in a var-centric
  [dv_max, V+1, B] tensor (info columns have exactly column_weight
  edges, parity columns <= 2, so padding waste is tiny; row V is a
  fake variable pinned at +LLR_MAX that absorbs all gather padding),
  check-node updates gather them into DEGREE-BUCKETED check-centric
  planes [dc_b, P_b, B] with *constant* indices (row degrees are
  heavily skewed, so per-bucket padding cuts gather and elementwise
  traffic >2x vs one max-degree plane), and no scatters are needed
  anywhere — each layout is the gather-inverse of the other.  The two-minimum
  rule is a single tournament fold over the slot planes
  (m1' = min(m1, |v|), m2' = min(m2, max(m1, |v|)) — see
  _check_update) rather than argmin/tie-count bookkeeping.

* Early termination is per-batch-element: a converged mask freezes each
  element's output at its first syndrome-clean iteration (matching the
  reference's early return, ldpc.c:1008-1015) while the whole batch
  exits as soon as every element has converged (lax.while_loop).

Integer semantics (int16 saturation at +/-32000, int32 accumulation,
alpha = 15/16 truncating division, first-minimum tie-breaking) follow
internal/ldpc.h:15-17,105-129 and ldpc.c:693-766 exactly; outputs are
bit-identical to the C library (tests/test_oracle_compat.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LdpcConfig, LdpcMatrixType, LdpcRate
from ..utils.rng import Xoshiro128pp
from ..utils import bits as bitutils
from ..utils import native

MIN_BLOCK_SIZE = 32
MAX_BLOCK_SIZE = 8192
MIN_COL_WEIGHT = 3
MAX_COL_WEIGHT = 8
DEFAULT_MAX_ITERATIONS = 50
LLR_MAX = 32000
LLR_MIN = -32000
LLR_INFINITY = 30000
LLR_SCALE = 256


class LdpcError(ValueError):
    pass


def _degree_buckets(row_counts: np.ndarray, max_buckets: int = 5):
    """Partition checks into <=max_buckets degree classes minimizing the
    total padded plane size sum(dc_b * P_b).  Exhaustive search over
    split degrees — the degree alphabet is tiny (<= ~20 values)."""
    degs = np.unique(row_counts)
    best, best_cost = None, None
    hist = {int(d): int((row_counts == d).sum()) for d in degs}

    def cost_of(splits):
        lo = 0
        total = 0
        for hi in splits:
            n = sum(v for d, v in hist.items() if lo < d <= hi)
            total += n * hi
            lo = hi
        return total

    import itertools

    dlist = [int(d) for d in degs]
    for k in range(1, min(max_buckets, len(dlist)) + 1):
        for mids in itertools.combinations(dlist[:-1], k - 1):
            splits = list(mids) + [dlist[-1]]
            c = cost_of(splits)
            if best_cost is None or c < best_cost:
                best, best_cost = splits, c

    out = []
    lo = 0
    for hi in best:
        sel = np.flatnonzero((row_counts > lo) & (row_counts <= hi))
        if len(sel):
            out.append(dict(checks=sel, dc=int(hi)))
        lo = hi
    return out


# =====================================================================
# Host-side structure construction (bit-exact with ldpc.c)
# =====================================================================

class LdpcStructure:
    def __init__(self, cfg: LdpcConfig):
        if (
            cfg.block_size < MIN_BLOCK_SIZE
            or cfg.block_size > MAX_BLOCK_SIZE
            or cfg.block_size % 4 != 0
        ):
            raise LdpcError(f"invalid block_size {cfg.block_size} (ldpc.c:821)")
        try:
            rate = LdpcRate(cfg.rate)
        except ValueError as e:
            raise LdpcError("invalid rate (ldpc.c:825)") from e
        self.cfg = cfg
        info_num, parity_num = rate.ratio
        self.info_bits = cfg.block_size * 8
        self.parity_bits = (self.info_bits * parity_num) // info_num
        self.codeword_bits = self.info_bits + self.parity_bits
        self.info_bytes = cfg.block_size
        self.parity_bytes = (self.parity_bits + 7) // 8
        self.codeword_bytes = self.info_bytes + self.parity_bytes

        cw = min(max(cfg.column_weight, MIN_COL_WEIGHT), MAX_COL_WEIGHT)
        self.col_weight = cw

        if cfg.matrix_type == LdpcMatrixType.QC_RANDOM:
            self._build_qc(cw)
        else:
            self._build_random(cw)
        self._build_column_view()
        self._build_interleaver()
        self._build_outer_interleaver()

    # -------------------------------------------------- matrix builders

    def _place_info_edges(self, targets: np.ndarray, info_cols: np.ndarray):
        """Shared CSR fill: info edges in draw order, then the staircase
        parity columns (ldpc.c:326-368)."""
        P = self.parity_bits
        V = self.codeword_bits
        info_counts = np.bincount(targets, minlength=P).astype(np.int64)
        row_counts = info_counts + np.where(np.arange(P) == 0, 1, 2)
        row_ptr = np.zeros(P + 1, dtype=np.int64)
        np.cumsum(row_counts, out=row_ptr[1:])
        used = int(row_ptr[-1])
        col_idx = np.zeros(used, dtype=np.int64)

        # info edges: within each row, in draw order (stable sort)
        order = np.argsort(targets, kind="stable")
        st = targets[order]
        info_start = np.zeros(P, dtype=np.int64)
        np.cumsum(info_counts[:-1], out=info_start[1:])
        ranks = np.arange(len(targets), dtype=np.int64) - info_start[st]
        col_idx[row_ptr[st] + ranks] = info_cols[order]

        # staircase parity part
        rows = np.arange(P, dtype=np.int64)
        base = row_ptr[rows] + info_counts
        col_idx[base[0]] = self.info_bits  # row 0: only its own parity col
        col_idx[base[1:]] = self.info_bits + rows[1:] - 1
        col_idx[base[1:] + 1] = self.info_bits + rows[1:]

        self.row_ptr = row_ptr
        self.col_idx = col_idx
        self.num_checks = P
        self.num_bits = V
        self.num_edges_used = used

    def _build_random(self, cw: int):
        """ldpc.c:283-411 — two identical RNG passes (count, then fill)."""
        seed = self.cfg.seed & 0xFFFFFFFF
        self.num_edges_alloc = self.info_bits * cw + 2 * self.parity_bits - 1
        nat = native.ldpc_build_random(
            seed, self.info_bits, self.parity_bits, cw, self.num_edges_alloc
        )
        if nat is not None:
            self._adopt_csr(*nat)
            return
        # pass 1 (counts) and pass 2 (fill) draw identical streams from
        # freshly-seeded RNGs, so one bulk draw serves both.
        rng = Xoshiro128pp(seed)
        draws = rng.draw_u32(self.info_bits * cw)
        targets = (draws % np.uint32(self.parity_bits)).astype(np.int64)
        info_cols = np.repeat(np.arange(self.info_bits, dtype=np.int64), cw)
        self._place_info_edges(targets, info_cols)

    def _adopt_csr(self, row_ptr, col_idx):
        self.row_ptr = row_ptr
        self.col_idx = col_idx
        self.num_checks = self.parity_bits
        self.num_bits = self.codeword_bits
        self.num_edges_used = int(row_ptr[-1])

    def _build_qc(self, cw: int):
        """ldpc.c:413-582 — quasi-cyclic lifting; out-of-range rows are
        dropped (ldpc.c:480-483)."""
        lifting = self.cfg.lifting_factor
        if lifting == 0:
            lifting = self.parity_bits // 8
            lifting = max(lifting, 4)
            lifting = min(lifting, 256)
            while lifting & (lifting - 1):
                lifting &= lifting - 1
        self.lifting_factor = lifting
        base_rows = (self.parity_bits + lifting - 1) // lifting

        seed = self.cfg.seed & 0xFFFFFFFF
        self.num_edges_alloc = self.info_bits * cw + 2 * self.parity_bits - 1
        nat = native.ldpc_build_qc(
            seed, self.info_bits, self.parity_bits, cw, lifting,
            self.num_edges_alloc,
        )
        if nat is not None:
            self._adopt_csr(*nat)
            return
        rng = Xoshiro128pp(seed)
        draws = rng.draw_u32(self.info_bits * cw * 2).astype(np.int64)
        block_row = draws[0::2] % base_rows
        shift = draws[1::2] % lifting
        i_idx = np.repeat(np.arange(self.info_bits, dtype=np.int64), cw)
        pos_in_block = i_idx % lifting
        row_in_block = (pos_in_block + shift) % lifting
        targets = block_row * lifting + row_in_block
        valid = targets < self.parity_bits
        self.num_edges_alloc = self.info_bits * cw + 2 * self.parity_bits - 1
        self._place_info_edges(targets[valid], i_idx[valid])

    def _build_column_view(self):
        """CSC view in row-scan order (ldpc.c:373-408)."""
        P = self.num_checks
        row_counts = np.diff(self.row_ptr)
        erow = np.repeat(np.arange(P, dtype=np.int64), row_counts)
        order = np.argsort(self.col_idx, kind="stable")
        col_counts = np.bincount(self.col_idx, minlength=self.num_bits)
        col_ptr = np.zeros(self.num_bits + 1, dtype=np.int64)
        np.cumsum(col_counts, out=col_ptr[1:])
        self.col_ptr = col_ptr
        self.cv_row_idx = erow[order]
        self.cv_edge_idx = order.astype(np.int64)
        self.erow = erow

    # ------------------------------------------------------ interleavers

    def _build_interleaver(self):
        """ldpc.c:150-234."""
        cfg = self.cfg
        if not cfg.use_inner_interleave:
            self.inner_forward = None
            self.inner_inverse = None
            self.inner_depth = 0
            return
        bits_n = self.codeword_bits
        depth = cfg.interleave_depth
        if depth == 0:
            depth = bits_n // 4
            depth = max(depth, 8)
            depth = min(depth, 256)
        width = (bits_n + depth - 1) // depth
        col_perm = np.arange(width, dtype=np.int64)
        seed = (cfg.seed ^ bits_n) & 0xFFFFFFFF
        rng = Xoshiro128pp(seed)
        for i in range(width - 1, 0, -1):
            j = rng.next_u32() % (i + 1)
            col_perm[i], col_perm[j] = col_perm[j], col_perm[i]

        i_arr = np.arange(bits_n, dtype=np.int64)
        row = i_arr // width
        col = i_arr % width
        pos = col_perm[col] * depth + row
        fwd = np.where((row < depth) & (pos < bits_n), pos, i_arr)
        inv = np.zeros(bits_n, dtype=np.int64)
        for i in range(bits_n):  # write order matters if fwd collides
            inv[fwd[i]] = i
        self.inner_forward = fwd
        self.inner_inverse = inv
        self.inner_depth = depth
        # Gather formulations of the reference's scatter loops
        # (interleave_bits/deinterleave_bits, ldpc.c:88-120): out is
        # zeroed first and writes happen in ascending i (last wins), so
        # out[j] = in[g[j]] with g the last preimage, -1 -> 0.
        inter_g = np.full(bits_n, -1, dtype=np.int64)
        inter_g[fwd] = i_arr          # ascending i => last wins
        deinter_g = np.full(bits_n, -1, dtype=np.int64)
        deinter_g[inv] = i_arr
        self.inner_interleave_gather = inter_g
        self.inner_deinterleave_gather = deinter_g

    def _build_outer_interleaver(self):
        """ldpc.c:236-281 — byte-level Fisher-Yates over the info bytes."""
        cfg = self.cfg
        if not cfg.use_outer_interleave:
            self.outer_forward = None
            self.outer_inverse = None
            return
        n = self.info_bytes
        fwd = np.arange(n, dtype=np.int64)
        seed = (cfg.seed ^ (self.info_bits ^ 0xDEADBEEF)) & 0xFFFFFFFF
        rng = Xoshiro128pp(seed)
        for i in range(n - 1, 0, -1):
            j = rng.next_u32() % (i + 1)
            fwd[i], fwd[j] = fwd[j], fwd[i]
        inv = np.zeros(n, dtype=np.int64)
        inv[fwd] = np.arange(n, dtype=np.int64)
        self.outer_forward = fwd
        self.outer_inverse = inv

    # ---------------------------------------------- decoder layout prep

    def decoder_layout(self):
        """Padded dual layouts + gather index maps for the BP kernel."""
        P, V = self.num_checks, self.num_bits
        E = self.num_edges_used
        row_counts = np.diff(self.row_ptr)
        col_counts = np.diff(self.col_ptr)
        dc = int(row_counts.max())
        dv = int(col_counts.max())

        # edge -> (check, slot) in CSR order
        e_c = self.erow
        e_s = np.arange(E, dtype=np.int64) - self.row_ptr[e_c]
        # edge -> (var, slot) in column-view order
        e_v = np.zeros(E, dtype=np.int64)
        e_t = np.zeros(E, dtype=np.int64)
        cv_pos = np.arange(E, dtype=np.int64)
        e_v[self.cv_edge_idx] = self.col_idx[self.cv_edge_idx]
        e_t[self.cv_edge_idx] = cv_pos - self.col_ptr[self.col_idx[self.cv_edge_idx]]

        # Slot-major layouts: messages live as [slots, C-or-V, B] with
        # the slot index on the LEADING axis, so min/sum reductions run
        # over axis 0 (accumulation over [C, B] slices).  Flat message
        # arrays are [slot*C + c] / [slot*V + v].
        #
        # Checks are PERMUTED into degree buckets: row degrees are
        # heavily skewed (binomial info draws + staircase), so padding
        # every check to the max degree more than doubles gather and
        # elementwise traffic.  Each bucket has its own padded plane
        # [dc_b, P_b, B]; check order is semantically irrelevant (the
        # syndrome is a conjunction), and all index arrays below are
        # built directly in bucketed storage order, so the permutation
        # costs nothing at runtime.
        buckets = _degree_buckets(row_counts)
        # bucketed storage position of each check + flat-layout offsets
        pos_in_bucket = np.zeros(P, dtype=np.int64)
        bucket_of = np.zeros(P, dtype=np.int64)
        offsets = np.zeros(len(buckets), dtype=np.int64)
        sizes = np.zeros(len(buckets), dtype=np.int64)
        off = 0
        for bi, b in enumerate(buckets):
            chk = b["checks"]
            pos_in_bucket[chk] = np.arange(len(chk), dtype=np.int64)
            bucket_of[chk] = bi
            offsets[bi] = off
            sizes[bi] = len(chk)
            off += b["dc"] * len(chk)
        c2v_size = off
        # edge -> flat bucketed c2v index
        eb = bucket_of[e_c]
        e_flat = offsets[eb] + e_s * sizes[eb] + pos_in_bucket[e_c]

        # Var-major tensors carry one trailing FAKE variable (index V)
        # whose channel/total/v2c stay at +LLR_MAX and whose bit stays
        # 0: check-side gathers and the syndrome point their padding
        # slots at it, so no mask/select pass is needed on the big
        # check-centric tensors.
        # check-centric gather of var-centric messages (per bucket, flat)
        check_gather = np.full(c2v_size, V, dtype=np.int64)  # slot0 of fake var
        check_gather[e_flat] = e_t * (V + 1) + e_v
        # var-centric gather of check-centric (bucketed flat) messages
        var_gather = np.full((dv, V + 1), c2v_size, dtype=np.int64)
        var_gather[e_t, e_v] = e_flat
        # column index per check slot (for syndrome checks), bucketed
        row2col = np.full(c2v_size, V, dtype=np.int64)
        row2col[e_flat] = self.col_idx

        # info-only row slots for the staircase encoder
        info_mask = self.col_idx < self.info_bits
        ic = self.erow[info_mask]
        icol = self.col_idx[info_mask]
        irank = np.zeros(len(ic), dtype=np.int64)
        # rank within row among info entries (CSR order => info entries
        # are contiguous from row start)
        irank = np.arange(E, dtype=np.int64)[info_mask] - self.row_ptr[ic]
        dci = int(np.bincount(ic, minlength=P).max()) if len(ic) else 1
        row_info = np.full((dci, P), self.info_bits, dtype=np.int64)
        row_info[irank, ic] = icol

        # dense parity-check matrix for matmul-based syndrome checks /
        # encodes on small codes (a matmul replaces the edge gather)
        H = None
        if P * V <= (1 << 24):
            # edge MULTIPLICITY matters mod 2: the reference XORs per
            # edge, so parallel edges (duplicate RNG draws) cancel
            Hcnt = np.zeros((P, V), dtype=np.int64)
            np.add.at(Hcnt, (e_c, self.col_idx), 1)
            H = (Hcnt & 1).astype(np.uint8)

        return dict(
            dc=dc, dv=dv, dci=dci,
            check_gather=check_gather, var_gather=var_gather,
            row2col=row2col, row_info=row_info, H=H,
            buckets=[
                dict(offset=int(offsets[bi]), P=int(sizes[bi]), dc=int(b["dc"]))
                for bi, b in enumerate(buckets)
            ],
            c2v_size=int(c2v_size),
        )


from ..utils.cache import LruCache

_STRUCT_CACHE = LruCache(capacity=16)


def get_structure(cfg: LdpcConfig) -> LdpcStructure:
    key = (
        cfg.block_size, int(cfg.rate), int(cfg.matrix_type), cfg.column_weight,
        cfg.use_inner_interleave, cfg.use_outer_interleave,
        cfg.interleave_depth, cfg.lifting_factor, cfg.seed,
    )
    return _STRUCT_CACHE.get_or_build(key, lambda: LdpcStructure(cfg))


# =====================================================================
# Device-side batched codec
# =====================================================================

class LDPCCodec:
    """Batched LDPC encode + min-sum BP decode (hard & soft)."""

    def __init__(self, cfg: LdpcConfig):
        self.cfg = cfg
        s = get_structure(cfg)
        self.structure = s
        self.info_bits = s.info_bits
        self.parity_bits = s.parity_bits
        self.codeword_bits = s.codeword_bits
        self.info_bytes = s.info_bytes
        self.parity_bytes = s.parity_bytes
        self.codeword_bytes = s.codeword_bytes
        self.max_iterations = cfg.max_iterations or DEFAULT_MAX_ITERATIONS

        lay = s.decoder_layout()
        self.dc, self.dv, self.dci = lay["dc"], lay["dv"], lay["dci"]
        self.buckets = lay["buckets"]
        self.c2v_size = lay["c2v_size"]
        i32 = jnp.int32
        # Sentinel-padded gather maps are split into (clipped index, pad
        # mask) pairs so the kernels never concatenate a pad row onto the
        # message tensors — that concat copies the whole tensor each
        # iteration and dominated BP wall-clock before this split.
        self.check_gather_idx = jnp.asarray(lay["check_gather"], i32)
        vg = lay["var_gather"].reshape(-1)
        self.var_gather_idx = jnp.asarray(np.minimum(vg, self.c2v_size - 1), i32)
        self.var_gather_pad = jnp.asarray((vg == self.c2v_size)[:, None])
        self.row2col_idx = jnp.asarray(lay["row2col"], i32)
        self.row_info = jnp.asarray(lay["row_info"], i32)
        self.H_dense = (
            jnp.asarray(lay["H"], jnp.bfloat16) if lay["H"] is not None else None
        )

        self.inner_fwd = (
            jnp.asarray(s.inner_forward, i32) if s.inner_forward is not None else None
        )
        self.inner_inv = (
            jnp.asarray(s.inner_inverse, i32) if s.inner_inverse is not None else None
        )
        self.inter_g = (
            jnp.asarray(s.inner_interleave_gather, i32)
            if s.inner_forward is not None else None
        )
        self.deinter_g = (
            jnp.asarray(s.inner_deinterleave_gather, i32)
            if s.inner_forward is not None else None
        )
        self.outer_fwd = (
            jnp.asarray(s.outer_forward, i32) if s.outer_forward is not None else None
        )
        self.outer_inv = (
            jnp.asarray(s.outer_inverse, i32) if s.outer_inverse is not None else None
        )

        # Execution-policy overrides (LdpcConfig; 0 = keep the default).
        # All three are pure wall-clock knobs — decode results are
        # bit-identical for every setting.
        if cfg.decode_chunk:
            self.DECODE_CHUNK = max(1, int(cfg.decode_chunk))
        if cfg.adaptive_stage1_iters:
            self.STAGE1_ITERS = int(cfg.adaptive_stage1_iters)
        if cfg.adaptive_straggler_slots:
            self.STRAGGLER_SLOTS = int(cfg.adaptive_straggler_slots)

    # ------------------------------------------------------- bit plumbing
    #
    # All device-side tensors are TRANSPOSED: bits/LLRs live as [V, B]
    # with the batch on the trailing axis, so every graph gather is an
    # axis-0 row gather of whole batch rows rather than a per-element
    # value gather.

    def _unpack_cw_T(self, codeword_bytes):
        """uint8 [B, bytes] -> bits [V, B] int32."""
        bits = bitutils.unpack_jnp(codeword_bytes, self.codeword_bits)
        return bits.astype(jnp.int32).T

    def _pack_cw_T(self, bits_T):
        """bits [V, B] -> uint8 [B, bytes]."""
        return bitutils.pack_jnp(bits_T.T.astype(jnp.uint8))

    def interleave_bits_T(self, bits_T):
        """out[fwd[i]] = in[i]  (ldpc.c:88-103) as an axis-0 gather (out
        zeroed, last write wins — inter_g holds the last preimage)."""
        if self.inner_fwd is None:
            return bits_T
        g = self.inter_g
        out = jnp.take(bits_T, jnp.clip(g, 0, None), axis=0)
        return jnp.where((g >= 0)[:, None], out, 0)

    def deinterleave_bits_T(self, bits_T):
        """out[inv[i]] = in[i]  (ldpc.c:105-120) as an axis-0 gather."""
        if self.inner_inv is None:
            return bits_T
        g = self.deinter_g
        out = jnp.take(bits_T, jnp.clip(g, 0, None), axis=0)
        return jnp.where((g >= 0)[:, None], out, 0)

    # ----------------------------------------------------------- encode

    @functools.partial(jax.jit, static_argnums=0)
    def _encode(self, info_bytes):
        bits_T = bitutils.unpack_jnp(info_bytes, self.info_bits).astype(jnp.int32).T
        B = bits_T.shape[1]
        if self.H_dense is not None:
            h_info = self.H_dense[:, : self.info_bits]
            s = jnp.dot(
                h_info, bits_T.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            ).astype(jnp.int32) & 1                 # [C, B] row info-sums
        else:
            padded = jnp.concatenate([bits_T, jnp.zeros((1, B), jnp.int32)], axis=0)
            g = jnp.take(padded, self.row_info.reshape(-1), axis=0)
            g = g.reshape(self.dci, self.parity_bits, B)
            s = g.sum(axis=0) & 1                   # [C, B] row info-sums
        parity = jnp.cumsum(s, axis=0) & 1          # staircase prefix-XOR
        return bitutils.pack_jnp(parity.T.astype(jnp.uint8))

    def encode(self, info):
        """Raw LDPC encode (no interleaving — the facade layers that):
        info uint8 [B, info_bytes] -> parity uint8 [B, parity_bytes]."""
        info = jnp.asarray(info)
        squeeze = info.ndim == 1
        if squeeze:
            info = info[None]
        out = self._encode(info)
        return out[0] if squeeze else out

    # ------------------------------------------------------ BP internals
    #
    # In-loop tensors carry one trailing FAKE variable (row V) whose
    # channel/total/v2c stay at +LLR_MAX and whose bit stays 0; gather
    # padding slots point at it, so the big check-centric tensors need
    # no mask/select pass at all.

    @staticmethod
    def _take(src, idx):
        """Axis-0 row gather."""
        return jnp.take(src, idx, axis=0)

    def _syndrome_ok_p(self, bits_p8):
        """bits int8 [V+1, B] (fake row = 0) -> [B] all-checks-satisfied
        (ldpc.c:635-653).

        Small codes: one matmul (H_dense @ bits, exact integer sums
        in f32) instead of a [c2v_size, B] row gather — the gather was
        a third of the BP loop's gather rows.  Edge multiplicity is
        already folded into H_dense mod 2.  Large codes: row gather +
        unrolled XOR over bucket planes."""
        B = bits_p8.shape[1]
        if self.H_dense is not None:
            # Info-column counts as a matmul (half the contraction dim);
            # the staircase parity columns contribute p[r-1] ^ p[r] —
            # a shift + add folded into the same mod-2 reduction.
            I = self.info_bits
            cnt = jnp.dot(
                self.H_dense[:, :I], bits_p8[:I].astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            ).astype(jnp.int32)                        # [P, B] info sums
            p = bits_p8[I : self.codeword_bits].astype(jnp.int32)
            p_prev = jnp.concatenate([jnp.zeros((1, B), jnp.int32), p[:-1]], 0)
            s = (cnt + p + p_prev) & 1                 # [P, B] syndrome bits
            return ~jnp.any(s, axis=0)
        g = self._take(bits_p8, self.row2col_idx)
        bad = None
        for bk in self.buckets:
            gb = g[bk["offset"] : bk["offset"] + bk["dc"] * bk["P"]].reshape(
                bk["dc"], bk["P"], B
            )
            acc = gb[0]
            for s in range(1, bk["dc"]):
                acc = acc ^ gb[s]
            any_b = jnp.any(acc, axis=0)
            bad = any_b if bad is None else (bad | any_b)
        return ~bad

    def _syndrome_ok_T(self, bits_T):
        """bits [V, B] -> [B] all-checks-satisfied."""
        B = bits_T.shape[1]
        bits_p = jnp.concatenate(
            [bits_T.astype(jnp.int8), jnp.zeros((1, B), jnp.int8)], axis=0
        )
        return self._syndrome_ok_p(bits_p)

    def _check_update(self, v2c):
        """Normalized two-minimum min-sum (ldpc.c:693-738).

        v2c: [(V+1)*dv, B] int16 var-centric messages (fake var row =
        +LLR_MAX).  Returns c2v [c2v_size, B] int16 in bucketed check
        order.  Storage/gather traffic stays int16 (bandwidth); the
        FOLD arithmetic runs in int32, widened once at the gathered
        plane and narrowed once at the output — bit-identical to an
        int16-typed fold (all values fit in int16 range; alpha = 15/16
        is (x*15)>>4, the exact C truncating division for the
        non-negative magnitudes).
        """
        B = v2c.shape[1]
        g = self._take(v2c, self.check_gather_idx)              # [c2v_size, B]

        # Two-minimum rule per degree bucket, as a single tournament
        # fold over the slot planes:  m2' = min(m2, max(m1, |v|)),
        # m1' = min(m1, |v|).  A duplicate of m1 drives m2 to m1, which
        # is exactly the reference's tie semantics ("min2 at the argmin
        # else min1" with min2 = min1 when min1 repeats) — verified
        # equivalent to the masked-strict-second-min formulation on all
        # row degrees.  One read of the gathered plane for the fold, one
        # for the output pass; no argmin/tie-count bookkeeping passes.
        outs = []
        for bk in self.buckets:
            dc, P = bk["dc"], bk["P"]
            gb = g[bk["offset"] : bk["offset"] + dc * P].reshape(dc, P, B)
            gb = gb.astype(jnp.int32)
            a = jnp.abs(gb)
            m1 = a[0]
            m2 = jnp.full_like(m1, LLR_MAX)
            par = gb[0] < 0
            for s in range(1, dc):
                m2 = jnp.minimum(m2, jnp.maximum(m1, a[s]))
                m1 = jnp.minimum(m1, a[s])
                par = par ^ (gb[s] < 0)
            a1 = (m1 * 15) >> 4
            a2 = (m2 * 15) >> 4
            mag = jnp.where(a == m1[None], a2[None], a1[None])
            out = jnp.where(par[None] ^ (gb < 0), -mag, mag)
            outs.append(out.reshape(dc * P, B).astype(jnp.int16))
        return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]

    def _var_update(self, c2v_flat, channel):
        """ldpc.c:740-766.  c2v_flat [c2v_size, B] int16 (bucketed);
        channel [V+1, B] int16.  Returns (llr_total [V+1, B] int16,
        v2c [(V+1)*dv, B] int16).  Sums run in int32 (the reference
        accumulates in int32 and only saturates the stored values,
        ldpc.c:753-764)."""
        B = c2v_flat.shape[1]
        Vp, dv = self.codeword_bits + 1, self.dv
        h = self._take(c2v_flat, self.var_gather_idx)
        h = jnp.where(self.var_gather_pad, jnp.int16(0), h).reshape(dv, Vp, B)
        total = channel.astype(jnp.int32)
        for s in range(dv):
            total = total + h[s]
        llr_total = jnp.clip(total, LLR_MIN, LLR_MAX).astype(jnp.int16)
        v2c = jnp.clip(total[None] - h, LLR_MIN, LLR_MAX).astype(jnp.int16)
        return llr_total, v2c.reshape(dv * Vp, B)

    def _bp_loop(self, llr_init_p, channel_soft_p, bits_init_p, conv0, max_iterations):
        """Shared BP driver (transposed layout, V+1 fake-var rows).

        llr_init_p [V+1, B] int16: initial llr_total (fake row > 0).
        channel_soft_p: None (hard: channel = previous llr_total,
        ldpc.c:746-751) or [V+1, B] int16 (soft: constant channel).
        bits_init_p [V+1, B] int8: output bits for pre-converged elements.
        conv0 [B] bool: pre-converged mask (hard path early exit).
        """
        Vp, B = llr_init_p.shape
        dv = self.dv
        llr_init_p = llr_init_p.astype(jnp.int16)
        v2c0 = jnp.broadcast_to(llr_init_p[None], (dv, Vp, B)).reshape(dv * Vp, B)

        state = dict(
            v2c=v2c0,
            llr=llr_init_p,
            out_bits=bits_init_p,
            last_bits=bits_init_p,
            converged=conv0,
            # derived from a varying input so the carry type is stable
            # under shard_map manual axes
            iters=llr_init_p[0, :].astype(jnp.int32) * 0,
            it=jnp.int32(0),
        )

        def cond(st):
            return (st["it"] < max_iterations) & ~jnp.all(st["converged"])

        def body(st):
            c2v = self._check_update(st["v2c"])
            channel = st["llr"] if channel_soft_p is None else channel_soft_p
            llr, v2c = self._var_update(c2v, channel)
            bits = (llr < 0).astype(jnp.int8)
            sat = self._syndrome_ok_p(bits)
            newly = sat & ~st["converged"]
            it1 = st["it"] + 1
            return dict(
                v2c=v2c,
                llr=llr,
                out_bits=jnp.where(newly[None, :], bits, st["out_bits"]),
                last_bits=bits,
                converged=st["converged"] | sat,
                iters=jnp.where(newly, it1, st["iters"]),
                it=it1,
            )

        st = jax.lax.while_loop(cond, body, state)
        ok = st["converged"]
        out = jnp.where(ok[None, :], st["out_bits"], st["last_bits"])
        iters = jnp.where(ok, st["iters"], max_iterations)
        iters = jnp.where(conv0, 0, iters)
        return ok, out, iters

    # ------------------------------------------------------------ decode

    def _chunked_scan(self, body, inp, max_iterations, chunk):
        """Run a decode body over chunk-wide slices via lax.scan (inside
        the caller's jit).  Chunk-width tensors keep the BP gathers in
        the fast regime and let each chunk's while_loop exit on its own
        worst element.  Callers pad ragged batches to a chunk multiple
        (_pad_to_chunk) before entering here.  `chunk` is threaded as
        an explicit static argument everywhere (reading it off `self`
        at trace time would let a mutated DECODE_CHUNK hit a stale jit
        cache entry)."""
        B = inp.shape[0]
        if B <= chunk or B % chunk != 0:
            return body(inp, max_iterations)
        chunks = inp.reshape(B // chunk, chunk, *inp.shape[1:])
        def sbody(_, ch):
            return 0, body(ch, max_iterations)
        _, (ok, cw, it) = jax.lax.scan(sbody, 0, chunks)
        return ok.reshape(-1), cw.reshape(B, -1), it.reshape(-1)

    def _pad_to_chunk(self, inputs):
        """Pad a ragged batch up to a DECODE_CHUNK multiple (by
        repeating leading rows — decode is per-element independent) so
        the plain paths keep the fast-gather chunking and per-chunk
        early exit on every batch size.  Returns (padded, orig_B)."""
        B = inputs.shape[0]
        chunk = self.DECODE_CHUNK
        if B <= chunk or B % chunk == 0:
            return inputs, B
        Bp = ((B + chunk - 1) // chunk) * chunk
        reps = -(-(Bp - B) // B)  # padding may exceed B for tiny overhangs
        pad = jnp.tile(inputs, (reps,) + (1,) * (inputs.ndim - 1))[: Bp - B]
        return jnp.concatenate([inputs, pad], axis=0), B

    def _decode_hard(self, codeword_bytes, max_iterations):
        padded, B = self._pad_to_chunk(jnp.asarray(codeword_bytes))
        ok, cw, it = self._decode_hard_jit(
            padded, max_iterations, self.DECODE_CHUNK
        )
        return ok[:B], cw[:B], it[:B]

    @functools.partial(jax.jit, static_argnums=(0, 2, 3))
    def _decode_hard_jit(self, codeword_bytes, max_iterations, chunk):
        return self._chunked_scan(
            self._decode_hard_body, codeword_bytes, max_iterations, chunk
        )

    def _decode_hard_body(self, codeword_bytes, max_iterations):
        bits_in = self._unpack_cw_T(codeword_bytes)
        work = self.deinterleave_bits_T(bits_in)               # [V, B] int32
        B = work.shape[1]
        work_p = jnp.concatenate([work, jnp.zeros((1, B), work.dtype)], axis=0)
        bits_p8 = work_p.astype(jnp.int8)
        conv0 = self._syndrome_ok_p(bits_p8)
        llr0 = jnp.where(work == 1, -LLR_INFINITY, LLR_INFINITY).astype(jnp.int16)
        # fake row must sit at exactly LLR_MAX: it pads min-reductions
        # in the check update, where any real |v2c| can reach LLR_MAX
        llr0_p = jnp.concatenate(
            [llr0, jnp.full((1, B), LLR_MAX, jnp.int16)], axis=0
        )
        ok, out, iters = self._bp_loop(
            llr0_p, None, bits_p8, conv0, max_iterations
        )
        return ok, self._pack_cw_T(out[: self.codeword_bits]), iters

    def _decode_soft(self, llr8, max_iterations):
        padded, B = self._pad_to_chunk(jnp.asarray(llr8, dtype=jnp.int8))
        ok, cw, it = self._decode_soft_jit(padded, max_iterations, self.DECODE_CHUNK)
        return ok[:B], cw[:B], it[:B]

    @functools.partial(jax.jit, static_argnums=(0, 2, 3))
    def _decode_soft_jit(self, llr8, max_iterations, chunk):
        return self._chunked_scan(
            self._decode_soft_body, llr8, max_iterations, chunk
        )

    def _decode_soft_body(self, llr8, max_iterations):
        """llr8: [B, codeword_bits] int8 channel LLRs."""
        work = llr8.astype(jnp.int32).T                        # [V, B]
        if self.inner_inv is not None:
            # deinterleave_llr (ldpc.c:136-148): out[inv[i]] = in[i].
            # (The C leaves never-written entries as malloc garbage; here
            # they are deterministically 0.)
            g = self.deinter_g
            work = jnp.where(
                (g >= 0)[:, None],
                jnp.take(work, jnp.clip(g, 0, None), axis=0),
                0,
            )
        B = work.shape[1]
        # fake var: 125 * LLR_SCALE == LLR_MAX exactly
        work_p = jnp.concatenate(
            [work, jnp.full((1, B), 125, work.dtype)], axis=0
        )
        channel = (work_p * LLR_SCALE).astype(jnp.int16)  # |llr*256| <= 32512
        llr0 = jnp.clip(work_p * LLR_SCALE, LLR_MIN, LLR_MAX).astype(jnp.int16)
        bits0 = jnp.zeros_like(work_p, dtype=jnp.int8)
        conv0 = (work[0, :] * 0).astype(bool)  # soft path has no pre-check
        ok, out, iters = self._bp_loop(
            llr0, channel, bits0, conv0, max_iterations
        )
        return ok, self._pack_cw_T(out[: self.codeword_bits]), iters

    # ------------------------------------------- adaptive fused decode
    #
    # BP trajectories are per-element deterministic and independent of
    # the rest of the batch, so a batch decode can run a short first
    # stage (where most codewords converge) and re-decode only the
    # compacted stragglers with the full iteration budget.  Results
    # (outputs AND iterations_used) are bit-identical to a single
    # full-budget call.
    #
    # The whole cascade is ONE jitted device program with no host round
    # trip: straggler compaction runs on-device (lax.top_k over the
    # not-converged mask), the full-budget re-decode covers a static
    # STRAGGLER_SLOTS-wide slice per pass, and an outer lax.while_loop
    # repeats until every element is finalized (converged or decoded at
    # full budget) — no data-dependent host decisions anywhere.

    # Execution-policy defaults (LdpcConfig overrides each).  Results
    # are bit-identical for any value; none is tuned on the GPU yet.
    # STAGE1_ITERS: first-stage budget of the adaptive cascade (most
    # error patterns at realistic channel qualities converge in 1-3 BP
    # iterations).  STRAGGLER_SLOTS: codewords per full-budget straggler
    # pass; the outer loop handles overflow.  DECODE_CHUNK: codewords
    # per BP chunk; narrow chunks exit the BP while_loop as soon as
    # their own worst element converges.
    STAGE1_ITERS = 3
    STRAGGLER_SLOTS = 256
    DECODE_CHUNK = 1024

    @functools.partial(jax.jit, static_argnums=(0, 1, 3, 4, 5, 6))
    def _decode_adaptive_fused(self, kind, inputs, s1, mx, nb, chunk):
        body = self._decode_hard_body if kind == "hard" else self._decode_soft_body
        B = inputs.shape[0]
        ok, cw, it = self._chunked_scan(body, inputs, s1, chunk)
        if s1 >= mx:
            return ok, cw, it

        def cond(st):
            return ~jnp.all(st[3])

        def wbody(st):
            ok, cw, it, done = st
            vals, sel = jax.lax.top_k((~done).astype(jnp.int32), nb)
            sub = jnp.take(inputs, sel, axis=0)
            ok2, cw2, it2 = body(sub, mx)
            # slots past the straggler count hold converged rows decoded
            # redundantly — sentinel index B drops their writes
            wsel = jnp.where(vals > 0, sel, B).astype(jnp.int32)
            return (
                ok.at[wsel].set(ok2, mode="drop"),
                cw.at[wsel].set(cw2, mode="drop"),
                it.at[wsel].set(it2, mode="drop"),
                done.at[wsel].set(True, mode="drop"),
            )

        st = jax.lax.while_loop(cond, wbody, (ok, cw, it, ok))
        return st[0], st[1], st[2]

    def _decode_adaptive(self, kind, inputs, max_iterations: int):
        """Adaptive decode driver: pad the batch to a chunk multiple,
        run the fused device cascade, slice the padding back off."""
        inputs, B = self._pad_to_chunk(jnp.asarray(inputs))
        chunk = self.DECODE_CHUNK
        s1 = min(self.STAGE1_ITERS, max_iterations)
        nb = min(self.STRAGGLER_SLOTS, inputs.shape[0])
        ok, cw, it = self._decode_adaptive_fused(
            kind, inputs, s1, max_iterations, nb, chunk
        )
        return ok[:B], cw[:B], it[:B]

    def decode_hard_adaptive(self, codeword, max_iterations: int = 0):
        """decode_hard with cascaded straggler compaction (bit-identical
        results).  Accepts host or device arrays; stays device-resident."""
        codeword = jnp.asarray(codeword, dtype=jnp.uint8)
        mi = max_iterations or self.max_iterations
        return self._decode_adaptive("hard", codeword, mi)

    def decode_soft_adaptive(self, llr, max_iterations: int = 0):
        llr = jnp.asarray(llr, dtype=jnp.int8)
        mi = max_iterations or self.max_iterations
        return self._decode_adaptive("soft", llr, mi)

    def decode_hard(self, codeword, max_iterations: int = 0):
        """codeword uint8 [B, codeword_bytes] -> (ok, codeword_out, iters).

        Matches poporon_ldpc_decode_hard (ldpc.c:971-1025): the returned
        codeword is the deinterleaved working word — best-effort when
        ok is False.
        """
        codeword = jnp.asarray(codeword)
        squeeze = codeword.ndim == 1
        if squeeze:
            codeword = codeword[None]
        mi = max_iterations or self.max_iterations
        ok, cw, iters = self._decode_hard(codeword, mi)
        return (ok[0], cw[0], iters[0]) if squeeze else (ok, cw, iters)

    def decode_soft(self, llr, max_iterations: int = 0):
        """llr int8 [B, codeword_bits] -> (ok, codeword_out, iters)."""
        llr = jnp.asarray(llr, dtype=jnp.int8)
        squeeze = llr.ndim == 1
        if squeeze:
            llr = llr[None]
        mi = max_iterations or self.max_iterations
        ok, cw, iters = self._decode_soft(llr, mi)
        return (ok[0], cw[0], iters[0]) if squeeze else (ok, cw, iters)

    def check(self, codeword):
        """poporon_ldpc_check (ldpc.c:962-969)."""
        codeword = jnp.asarray(codeword)
        squeeze = codeword.ndim == 1
        if squeeze:
            codeword = codeword[None]
        ok = self._syndrome_ok_T(self._unpack_cw_T(codeword))
        return ok[0] if squeeze else ok

    # --------------------------------------------------- byte interleave

    def interleave(self, codeword_bytes):
        cb = jnp.asarray(codeword_bytes)
        bits_T = self._unpack_cw_T(cb)
        return self._pack_cw_T(self.interleave_bits_T(bits_T))

    def deinterleave(self, codeword_bytes):
        cb = jnp.asarray(codeword_bytes)
        bits_T = self._unpack_cw_T(cb)
        return self._pack_cw_T(self.deinterleave_bits_T(bits_T))
