#!/usr/bin/env python3
"""Run the FEC codecs end to end on the GPU and check them bit for bit.

    python chip_smoke.py              # one GPU: every codec phase
    python chip_smoke.py --chips 4    # four GPUs: the sharded path only

One-GPU mode first runs the ``gpu``-marked tests in a child process,
before this process touches the card, so that only one process holds it
at a time.  It then drives the public facade -- ``pp.create(cfg)``,
``.encode`` and ``.decode``, host bytes in and host bytes out -- at the
batch sizes bench.py uses:

    rs_plain         RS(255,223), B=131072: 2 symbol errors per row, plus
                     rows with exactly t=16 and with 17 errors
    rs_erasure       RS(255,223), B=131072, 32 erasures per row
    rs_ext_syndrome  RS(255,223), B=131072, syndromes computed on the host
    bch              BCH(15,5), B=131072, 0-3 bit errors plus 4-error rows
    ldpc_hard        LDPC 128B rate 1/2 default preset, B=131072, 4 flips
    ldpc_soft        the same code, soft LLRs at ~1e-2 channel BER
    ldpc_qc          LDPC 128B rate 1/2 QC matrix, B=65536, 4 flips
    ldpc_8192        LDPC 8192B rate 1/3, B=512, 120 flips

Each phase checks every row the code can correct against the original
data, and checks a subset of rows bit for bit (ok, data, parity,
corrected / iterations) against the same facade call on the CPU backend
of this process -- the path tests/test_oracle_compat.py holds to the C
library.  Each phase prints one line: its setup and compile seconds, the
median of 3 timed calls, ``compiled.memory_analysis()`` of its main
decode program and the device's peak bytes in use so far.

Four-GPU mode runs ShardedCodec's RS and LDPC decode and the shard_map
LDPC decode step with psum statistics on a 4-device mesh at 4x the
one-GPU batch, compares each with a one-GPU run of the same inputs, and
prints each output's sharding, its bytes per device and the collectives
of every compiled step.

The last line of stdout is ``{"ok": true, "device": {...}}``.  Without a
GPU, outside a checkout of the repository, or on any failure, the script
exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np

ROOT = Path(__file__).resolve().parent
PACKAGE = "libpoporon_jax"

ONE_CHIP_PHASES = (
    "gpu_tests", "rs_plain", "rs_erasure", "rs_ext_syndrome", "bch",
    "ldpc_hard", "ldpc_soft", "ldpc_qc", "ldpc_8192",
)
FOUR_CHIP_PHASES = ("sharded",)

# phase -> (batch, rows compared with the CPU backend)
SIZES = {
    "rs_plain": (131072, 8192),
    "rs_erasure": (131072, 8192),
    "rs_ext_syndrome": (131072, 8192),
    "bch": (131072, 8192),
    "ldpc_hard": (131072, 2048),
    "ldpc_soft": (131072, 2048),
    "ldpc_qc": (65536, 2048),
    "ldpc_8192": (512, 16),
}
SHARDED_BATCH = 131072        # per device, RS and LDPC facade decode
SHARDED_STEP_BATCH = 16384    # per device, full-budget shard_map step
TIMED_CALLS = 3
MIN_CONVERGED = 0.9           # LDPC rows that must converge (~0.996 seen)
SEED = 0                      # inputs (data, errors, noise) are drawn from it
FIELDS = ("ok", "data", "parity", "corrected")
COLLECTIVES = ("all-gather", "all-reduce", "all-to-all",
               "collective-permute", "reduce-scatter")


class SmokeError(RuntimeError):
    pass


def _expect(cond, msg):
    if not cond:
        raise SmokeError(msg)


# ------------------------------------------------------------- helpers

def select_phases(chips: int) -> tuple[str, ...]:
    if chips == 1:
        return ONE_CHIP_PHASES
    if chips == 4:
        return FOUR_CHIP_PHASES
    raise SmokeError(f"--chips must be 1 or 4, got {chips}")


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    output -> [(name, power limit)] per card."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip() or not limit.strip():
            raise SmokeError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    if not cards:
        raise SmokeError("nvidia-smi listed no GPU")
    return cards


def query_nvidia_smi() -> str:
    """Card names and power limits, read by a child that never imports JAX."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeError(f"no NVIDIA GPU: nvidia-smi failed ({e})") from e
    if proc.returncode != 0:
        raise SmokeError(f"no NVIDIA GPU: nvidia-smi exited {proc.returncode}: "
                         f"{proc.stderr.strip()}")
    return proc.stdout.strip()


def require_gpu(devices, chips: int):
    """The first `chips` GPUs; refuses any other platform."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise SmokeError(f"needs a GPU; JAX found {kind} devices")
    if len(devices) < chips:
        raise SmokeError(f"needs {chips} GPUs; JAX found {len(devices)}")
    return devices[:chips]


def result_line(device, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count}})


def compare_outputs(got: dict, want: dict) -> list[str]:
    """Fields of `got` that differ from `want` in any bit (or shape)."""
    bad = []
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append(f"{k}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        elif not np.array_equal(a, b):
            rows = np.unique(np.nonzero(a != b)[0])
            bad.append(f"{k}: {len(rows)} rows differ, first {rows[:8].tolist()}")
    return bad


def hlo_collectives(hlo_text: str) -> dict:
    """Count collective instructions in compiled HLO text, by kind."""
    counts = {}
    for kind in COLLECTIVES:
        n = len(re.findall(rf"\s{kind}(?:-start)?\(", hlo_text))
        if n:
            counts[kind] = n
    return counts


def memory_summary(compiled) -> dict:
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {k: int(getattr(m, f"{k}_size_in_bytes")) for k in
            ("argument", "output", "temp", "generated_code")}


def peak_bytes(device):
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def fetch(res) -> dict:
    """DecodeResult -> host arrays (the fetch ends a timed call)."""
    return {k: np.asarray(getattr(res, k)) for k in FIELDS}


def take_rows(x, n: int):
    if isinstance(x, tuple):
        return tuple(take_rows(v, n) for v in x)
    return x[:n]


def distinct_positions(rng, B: int, n: int, k: int) -> np.ndarray:
    """[B, k] sorted positions in [0, n), distinct within each row."""
    if k * k > n:                     # collisions likely: shuffle instead
        perm = rng.permuted(np.tile(np.arange(n), (B, 1)), axis=1)
        return np.sort(perm[:, :k], axis=1)
    pos = np.sort(rng.integers(0, n, (B, k)), axis=1)
    while True:
        dup = (np.diff(pos, axis=1) == 0).any(axis=1)
        if not dup.any():
            return pos
        pos[dup] = np.sort(rng.integers(0, n, (int(dup.sum()), k)), axis=1)


def flip_bits(cw: np.ndarray, nflips: int, rng) -> np.ndarray:
    """Flip `nflips` distinct random bits in every row of a byte array."""
    B, nbytes = cw.shape
    pos = distinct_positions(rng, B, nbytes * 8, nflips)
    out = cw.copy()
    rows = np.arange(B)[:, None]
    out[rows, pos // 8] ^= (1 << (7 - pos % 8)).astype(np.uint8)
    return out


def corrupt_symbols(word: np.ndarray, nerr: np.ndarray, rng) -> np.ndarray:
    """XOR a random nonzero value into nerr[i] distinct symbols of row i."""
    B, n = word.shape
    k = int(nerr.max())
    out = word.copy()
    if k == 0:
        return out
    pos = distinct_positions(rng, B, n, k)
    vals = rng.integers(1, 256, (B, k)).astype(np.uint8)
    vals[np.arange(k)[None, :] >= nerr[:, None]] = 0
    out[np.arange(B)[:, None], pos] ^= vals
    return out


# -------------------------------------------------------------- phases

@dataclasses.dataclass
class Inputs:
    args: tuple                          # host arrays: data, parity
    kwargs: dict                         # host erasures / ext_syndrome / soft_llr
    check: Callable[[dict], dict]        # ground-truth check of host outputs
    program: Callable[[object], tuple]   # codec -> (jitted fn, lower() args)


def _rs_program(codec, data, parity):
    """The facade's plain RS decode program and its arguments."""
    import jax.numpy as jnp
    rs = codec._rs
    return type(rs)._decode_plain, (rs, jnp.asarray(data), jnp.asarray(parity))


def _ldpc_program(codec, kind, inputs):
    """The facade's adaptive LDPC decode program and its arguments
    (inputs: codewords or LLRs, [B, ...] with B a chunk multiple)."""
    import jax.numpy as jnp
    lc = codec._ldpc
    mi = lc.max_iterations
    B = inputs.shape[0]
    _expect(B <= lc.DECODE_CHUNK or B % lc.DECODE_CHUNK == 0,
            "LDPC phase batch must be a chunk multiple")
    args = (lc, kind, jnp.asarray(inputs), min(lc.STAGE1_ITERS, mi), mi,
            min(lc.STRAGGLER_SLOTS, B), lc.DECODE_CHUNK)
    return type(lc)._decode_adaptive_fused, args


def build_rs_plain(codec, B, rng) -> Inputs:
    data = rng.integers(0, 256, (B, 223), dtype=np.uint8)
    parity = np.asarray(codec.encode(data).parity)
    nerr = np.full(B, 2)
    q = max(1, B // 64)
    nerr[:q] = 16                    # exactly t: still correctable
    nerr[q : 2 * q] = 17             # t + 1: must fail
    word = corrupt_symbols(np.concatenate([data, parity], 1), nerr, rng)
    bad_d, bad_p = word[:, :223], word[:, 223:]

    def check(out):
        good = nerr <= 16
        _expect(out["ok"][good].all(), "a correctable row failed")
        _expect((out["data"][good] == data[good]).all(), "data not restored")
        _expect((out["parity"][good] == parity[good]).all(), "parity not restored")
        _expect((out["corrected"][good] == nerr[good]).all(), "corrected count")
        _expect(not out["ok"][~good].any(), "a 17-error row reported ok")
        return {"rows_checked": int(B), "failed_as_expected": int((~good).sum())}

    return Inputs((bad_d, bad_p), {}, check,
                  lambda c: _rs_program(c, bad_d, bad_p))


def build_rs_erasure(codec, B, rng) -> Inputs:
    E = 32
    data = rng.integers(0, 256, (B, 223), dtype=np.uint8)
    parity = np.asarray(codec.encode(data).parity)
    pos = distinct_positions(rng, B, 223, E).astype(np.int32)
    bad = data.copy()
    bad[np.arange(B)[:, None], pos] ^= rng.integers(
        1, 256, (B, E)).astype(np.uint8)
    cnt = np.full(B, E, np.int32)

    def check(out):
        _expect(out["ok"].all(), "an erasure row failed")
        _expect((out["data"] == data).all(), "data not restored")
        _expect((out["parity"] == parity).all(), "parity changed")
        return {"rows_checked": int(B)}

    def program(c):
        import jax.numpy as jnp
        rs = c._rs
        return type(rs)._decode_erasure, (
            rs, jnp.asarray(bad), jnp.asarray(parity), jnp.asarray(pos),
            jnp.asarray(cnt))

    return Inputs((bad, parity), {"erasures": (pos, cnt)}, check, program)


def host_syndromes_log(err_word: np.ndarray, cfg) -> np.ndarray:
    """Log-form syndromes of an error pattern over a full-length word,
    computed on the host from the GF tables: S_i = sum_j e_j *
    alpha^((fcr+i)*prim*(fs-1-j)), sentinel fs for zero."""
    from libpoporon_jax.ops.gf import GF
    gf = GF(cfg.symbol_size, cfg.generator_polynomial)
    fs = gf.field_size
    l2e = gf.log2exp.astype(np.int64)
    e2l = gf.exp2log.astype(np.int64)
    B, n = err_word.shape
    rows, cols = np.nonzero(err_word)
    elog = e2l[err_word[rows, cols]]
    S = np.zeros((B, cfg.num_roots), np.int64)
    for i in range(cfg.num_roots):
        k = ((cfg.first_consecutive_root + i) * cfg.primitive_element
             * (fs - 1 - cols)) % fs
        np.bitwise_xor.at(S[:, i], rows, l2e[(elog + k) % fs])
    return e2l[S].astype(np.int32)


def build_rs_ext_syndrome(codec, B, rng) -> Inputs:
    cfg = codec.config
    data = rng.integers(0, 256, (B, 223), dtype=np.uint8)
    parity = np.asarray(codec.encode(data).parity)
    nerr = np.full(B, 2)
    nerr[: max(1, B // 64)] = 0      # all-sentinel rows: "no error"
    clean = np.concatenate([data, parity], 1)
    word = corrupt_symbols(clean, nerr, rng)
    s_log = host_syndromes_log(word ^ clean, cfg)
    bad_d, bad_p = word[:, :223], word[:, 223:]

    def check(out):
        _expect(out["ok"].all(), "an external-syndrome row failed")
        _expect((out["data"] == data).all(), "data not restored")
        _expect((out["parity"] == parity).all(), "parity not restored")
        _expect((out["corrected"] == nerr).all(), "corrected count")
        return {"rows_checked": int(B)}

    def program(c):
        import jax.numpy as jnp
        rs = c._rs
        return type(rs)._decode_ext_syndrome, (
            rs, jnp.asarray(bad_d), jnp.asarray(bad_p), jnp.asarray(s_log))

    return Inputs((bad_d, bad_p), {"ext_syndrome": s_log}, check, program)


def build_bch(codec, B, rng) -> Inputs:
    bch = codec._bch
    n, pb = bch.n, bch.parity_bits
    data = rng.integers(0, 1 << bch.data_length, (B, bch.data_bytes),
                        dtype=np.uint8)
    parity = np.asarray(codec.encode(data).parity)
    nerr = rng.integers(0, bch.t + 1, B)
    nerr[: max(1, B // 64)] = bch.t + 1          # beyond t: compared only
    pos = rng.permuted(np.tile(np.arange(n), (B, 1)), axis=1)
    bad_d, bad_p = data.copy(), parity.copy()
    for k in range(bch.t + 1):
        r = np.nonzero(nerr > k)[0]
        j = pos[r, k]                           # LSB-first codeword bit
        par = j < pb
        rp, jp = r[par], j[par]
        bad_p[rp, bch.parity_bytes - 1 - jp // 8] ^= (1 << (jp % 8)).astype(np.uint8)
        rd, jd = r[~par], j[~par] - pb
        bad_d[rd, bch.data_bytes - 1 - jd // 8] ^= (1 << (jd % 8)).astype(np.uint8)

    def check(out):
        good = nerr <= bch.t
        _expect(out["ok"][good].all(), "a correctable row failed")
        _expect((out["data"][good] == data[good]).all(), "data not restored")
        _expect((out["corrected"][good] == nerr[good]).all(), "corrected count")
        return {"rows_checked": int(good.sum())}

    def program(c):
        import jax.numpy as jnp
        b = c._bch
        received = jnp.concatenate([b.pack_parity(bad_p), b.pack_data(bad_d)], -1)
        return type(b)._decode_bits, (b, received)

    return Inputs((bad_d, bad_p), {}, check, program)


def _ldpc_check(info):
    def check(out):
        ok = out["ok"]
        _expect((out["data"][ok] == info[ok]).all(),
                "a converged row decoded to the wrong data")
        frac = float(ok.mean())
        _expect(frac >= MIN_CONVERGED, f"only {frac:.4f} of rows converged")
        return {"rows_checked": int(ok.sum()), "converged_fraction": frac,
                "max_iterations_used": int(out["corrected"].max())}
    return check


def build_ldpc_hard(codec, B, rng, nflips=4) -> Inputs:
    lc = codec._ldpc
    info = rng.integers(0, 256, (B, lc.info_bytes), dtype=np.uint8)
    enc = codec.encode(info.copy())
    cw = flip_bits(np.concatenate([np.asarray(enc.data), np.asarray(enc.parity)], 1),
                   nflips, rng)
    bad_d, bad_p = cw[:, : lc.info_bytes], cw[:, lc.info_bytes:]
    return Inputs((bad_d, bad_p), {}, _ldpc_check(info),
                  lambda c: _ldpc_program(c, "hard", cw))


def build_ldpc_soft(codec, B, rng) -> Inputs:
    from libpoporon_jax.utils import bits as bitutils
    lc = codec._ldpc
    info = rng.integers(0, 256, (B, lc.info_bytes), dtype=np.uint8)
    enc = codec.encode(info.copy())
    cw = np.concatenate([np.asarray(enc.data), np.asarray(enc.parity)], 1)
    cb = bitutils.unpack_np(cw, lc.codeword_bits)
    # +-90 LLRs with sigma 38.6: P(sign flip) ~ 1e-2 (bench.py's channel)
    noisy = np.where(cb == 1, -90.0, 90.0).astype(np.float32)
    noisy += rng.normal(0, 38.6, cb.shape).astype(np.float32)
    llr = np.clip(np.round(noisy), -127, 127).astype(np.int8)
    hard = bitutils.pack_np((llr < 0).astype(np.uint8))
    bad_d, bad_p = hard[:, : lc.info_bytes], hard[:, lc.info_bytes:]
    check = _ldpc_check(info)

    def check_ber(out):
        res = check(out)
        res["channel_ber"] = float(((llr < 0) != (cb == 1)).mean())
        return res

    return Inputs((bad_d, bad_p), {"soft_llr": llr}, check_ber,
                  lambda c: _ldpc_program(c, "soft", llr))


def phase_specs():
    import libpoporon_jax as pp
    from libpoporon_jax.config import LdpcConfig, LdpcMatrixType, LdpcRate
    r12 = LdpcRate.RATE_1_2
    return {
        "rs_plain": (pp.rs_config_default(), build_rs_plain),
        "rs_erasure": (pp.rs_config_default(), build_rs_erasure),
        "rs_ext_syndrome": (pp.rs_config_default(), build_rs_ext_syndrome),
        "bch": (pp.bch_config_default(), build_bch),
        "ldpc_hard": (pp.ldpc_config_default(128, r12), build_ldpc_hard),
        "ldpc_soft": (pp.ldpc_config_default(128, r12), build_ldpc_soft),
        "ldpc_qc": (LdpcConfig(block_size=128, rate=r12,
                               matrix_type=LdpcMatrixType.QC_RANDOM),
                    build_ldpc_hard),
        "ldpc_8192": (LdpcConfig(block_size=8192, rate=LdpcRate.RATE_1_3),
                      lambda c, B, rng: build_ldpc_hard(c, B, rng, nflips=120)),
    }


def run_phase(name, batch, ref_rows, rng, device, ref_device) -> dict:
    """One codec phase on `device`, checked against ground truth and
    against `ref_device` on the first `ref_rows` rows."""
    import jax
    import libpoporon_jax as pp

    cfg, build = phase_specs()[name]
    t0 = time.perf_counter()
    with jax.default_device(device):
        codec = pp.create(cfg)
        inp = build(codec, batch, rng)
        setup_s = time.perf_counter() - t0

        fn, fargs = inp.program(codec)
        t0 = time.perf_counter()
        compiled = fn.lower(*fargs).compile()
        compile_s = time.perf_counter() - t0

        def call():
            return fetch(codec.decode(*inp.args, **inp.kwargs))

        t0 = time.perf_counter()
        out = call()
        first_call_s = time.perf_counter() - t0
        times = []
        for _ in range(TIMED_CALLS):
            t0 = time.perf_counter()
            again = call()
            times.append(time.perf_counter() - t0)
            _expect(not compare_outputs(again, out), "repeated call differs")
    truth = inp.check(out)

    with jax.default_device(ref_device):
        ref_codec = pp.create(cfg)
        sub_args = take_rows(inp.args, ref_rows)
        sub_kwargs = {k: take_rows(v, ref_rows) for k, v in inp.kwargs.items()}
        ref = fetch(ref_codec.decode(*sub_args, **sub_kwargs))
    diff = compare_outputs({k: v[:ref_rows] for k, v in out.items()}, ref)
    if diff:
        raise SmokeError(f"{name}: differs from the {ref_device.platform} "
                         f"backend: {diff}")
    median = statistics.median(times)
    return {
        "result": "pass", "batch": batch, **truth,
        "ref_rows_bit_identical": ref_rows,
        "setup_s": setup_s, "compile_s": compile_s,
        "first_call_s": first_call_s, "median_s": median,
        "codewords_per_s": batch / median,
        "memory_analysis": memory_summary(compiled),
        "peak_bytes_in_use": peak_bytes(device),
    }


def run_gpu_tests() -> dict:
    """The gpu-marked tests in a child process (before this process
    touches the card)."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-o", "addopts=", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "tests/"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    passed = re.search(r"(\d+) passed", summary)
    if proc.returncode != 0 or not passed or re.search(
            r"skipped|failed|error", summary):
        sys.stderr.write(proc.stdout[-8000:] + proc.stderr[-4000:])
        raise SmokeError(f"gpu-marked tests: rc={proc.returncode}: {summary!r}")
    return {"result": "pass", "passed": int(passed.group(1)),
            "seconds": time.perf_counter() - t0}


# ------------------------------------------------------------ sharded

def _shard_report(arr) -> dict:
    return {"sharding": str(arr.sharding),
            "bytes_per_device": [int(s.data.nbytes) for s in arr.addressable_shards]}


def run_sharded(devices, batch_per_dev, step_per_dev, rng) -> dict:
    """ShardedCodec decode (RS, LDPC) and the shard_map LDPC step over a
    mesh of `devices`, each compared with one device on the same inputs."""
    import jax
    import libpoporon_jax as pp
    from libpoporon_jax.config import LdpcRate
    from libpoporon_jax.parallel import ShardedCodec, batch_mesh

    n = len(devices)
    mesh = batch_mesh(devices)
    report = {}
    with jax.default_device(devices[0]):
        for name, cfg, build, kind in (
            ("rs_plain", pp.rs_config_default(), build_rs_plain, None),
            ("ldpc_hard", pp.ldpc_config_default(128, LdpcRate.RATE_1_2),
             build_ldpc_hard, "hard"),
        ):
            codec = pp.create(cfg)
            sc = ShardedCodec(codec, mesh)
            inp = build(codec, n * batch_per_dev, rng)
            t0 = time.perf_counter()
            res = sc.decode(*inp.args)
            sharded = fetch(res)
            first_s = time.perf_counter() - t0
            times = []
            for _ in range(TIMED_CALLS):
                t0 = time.perf_counter()
                fetch(sc.decode(*inp.args))
                times.append(time.perf_counter() - t0)
            # one device, one per-device slice at a time (the shapes of the
            # one-GPU phases, so their compiled programs are reused)
            parts = [fetch(codec.decode(*(x[i * batch_per_dev:(i + 1) * batch_per_dev]
                                          for x in inp.args)))
                     for i in range(n)]
            one = {k: np.concatenate([q[k] for q in parts]) for k in FIELDS}
            diff = compare_outputs(sharded, one)
            _expect(not diff, f"sharded {name} differs from one device: {diff}")
            truth = inp.check(sharded)
            d_sh, p_sh = sc._put(inp.args[0]), sc._put(inp.args[1])
            if kind is None:
                fn, args = _rs_program(codec, d_sh, p_sh)
            else:
                cw = jax.numpy.concatenate([d_sh, p_sh], axis=-1)
                fn, args = _ldpc_program(codec, kind, cw)
            hlo = fn.lower(*args)
            report[name] = {
                "batch": n * batch_per_dev, "bit_identical_to_one_device": True,
                **truth, "first_call_s": first_s,
                "median_s": statistics.median(times),
                "outputs": {k: _shard_report(getattr(res, k)) for k in FIELDS},
                "collectives": hlo_collectives(hlo.compile().as_text()),
            }

        codec = pp.create(pp.ldpc_config_default(128, LdpcRate.RATE_1_2))
        sc = ShardedCodec(codec, mesh)
        inp = build_ldpc_hard(codec, n * step_per_dev, rng)
        cw = np.concatenate(inp.args, axis=1)
        t0 = time.perf_counter()
        ok, out, iters, stats = sc.ldpc_decode_step(cw)
        got = {"ok": np.asarray(ok), "data": np.asarray(out),
               "corrected": np.asarray(iters)}
        step_s = time.perf_counter() - t0
        ok1, out1, it1 = codec._ldpc.decode_hard(cw)
        want = {"ok": np.asarray(ok1), "data": np.asarray(out1),
                "corrected": np.asarray(it1)}
        diff = compare_outputs(got, want)
        _expect(not diff, f"shard_map step differs from one device: {diff}")
        _expect(stats == {"converged": int(want["ok"].sum()),
                          "iterations_total": int(want["corrected"].sum())},
                f"psum statistics {stats} disagree with one device")
        step = sc.ldpc_step_program()
        hlo = step.lower(sc._put(cw)).compile().as_text()
        report["ldpc_decode_step"] = {
            "batch": n * step_per_dev, "bit_identical_to_one_device": True,
            "stats": stats, "first_call_s": step_s,
            "outputs": {"ok": _shard_report(ok), "codeword": _shard_report(out)},
            "collectives": hlo_collectives(hlo),
        }
    report["peak_bytes_in_use"] = [peak_bytes(d) for d in devices]
    return report


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="1: every codec phase on one GPU; 4: the sharded "
                         "path on four GPUs")
    args = ap.parse_args(argv)
    phases = select_phases(args.chips)

    if importlib.util.find_spec(PACKAGE) is None or not (ROOT / "tests").is_dir():
        raise SmokeError(f"run from a checkout of the repository ({PACKAGE} "
                         "and tests/ beside this script)")
    smi = query_nvidia_smi()
    parse_nvidia_smi(smi)
    for line in smi.splitlines():
        print(f"nvidia-smi: {line}", flush=True)
    if "gpu_tests" in phases:
        print("phase gpu_tests: " + json.dumps(run_gpu_tests()), flush=True)

    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"  # the reference backend
    import jax
    from libpoporon_jax.utils import native
    from libpoporon_jax.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    devices = require_gpu(jax.devices(), args.chips)
    cpu = jax.devices("cpu")[0]
    print("device: " + json.dumps({
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(jax.devices()), "jax": jax.__version__,
        "native_core": native.available(), "compile_cache": cache_dir,
    }), flush=True)

    rng = np.random.default_rng(SEED)
    for name in phases:
        if name == "gpu_tests":
            continue
        if name == "sharded":
            rec = run_sharded(devices, SHARDED_BATCH, SHARDED_STEP_BATCH, rng)
        else:
            batch, ref_rows = SIZES[name]
            rec = run_phase(name, batch, ref_rows, rng, devices[0], cpu)
        print(f"phase {name}: " + json.dumps(rec), flush=True)

    print(result_line(devices[0], len(jax.devices())), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
