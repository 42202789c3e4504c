"""Benchmark harness.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Primary metric: RS(255,223) decode throughput (2 symbol errors per
codeword — the README example config, BASELINE.json config #1/#2) in
codewords/s on one GPU.  vs_baseline is the speedup over the reference
C library (compiled from /root/reference, scalar path) measured on this
host — the reference publishes no numbers of its own (BASELINE.md).

Methodology note (applies to every vs-reference ratio printed here):
the device figures are steady-state PIPELINED throughput at large batch
(dispatch all iterations, block once), while the reference-C figures
are synchronous single-core per-call timing, since the C library
processes one codeword per call and has no pipeline to fill.

Secondary metrics (LDPC BP Mbit/s, RS encode, BCH, erasure decode) are
printed to stderr as JSON lines prefixed with '#'.  Without a GPU the
bench refuses to run, except in smoke mode (POPORON_BENCH_SMOKE=1), which
pins the CPU and times nothing meaningful.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

# Batch sizes: the per-iteration fixed costs (BM's 32 serial steps,
# BP's while_loop bookkeeping) amortize over the batch.  131072
# codewords of RS(255,223) is ~33MB of input — small for device
# memory, and the scale BASELINE config #4 asks for (100k).
BATCH = 131072
LDPC_BATCH = 131072

# Smoke mode (ci.sh): tiny batches on CPU — exercises every bench code
# path in seconds, producing no meaningful throughput numbers.
import os

SMOKE = os.environ.get("POPORON_BENCH_SMOKE", "") == "1"
if SMOKE:
    BATCH = 1024
    LDPC_BATCH = 2048


def log(obj):
    print("# " + json.dumps(obj), file=sys.stderr, flush=True)


def time_fn(fn, *args, warmup=2, iters=5):
    """Steady-state throughput timing: dispatch all iterations
    back-to-back (the device pipeline stays full, as in a production
    streaming deployment) and block once at the end."""
    import jax

    for _ in range(warmup):
        out = fn(*args)
        jax.block_until_ready(out)
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / iters


def bench_reference_ldpc(cw, n=256):
    """Reference C library LDPC hard decode, codewords/s (single core)."""
    sys.path.insert(0, "tests")
    try:
        import oracle

        if not oracle.available():
            return None
        ref = oracle.LDPC(128, 1)
        t0 = time.perf_counter()
        for i in range(n):
            ref.decode_hard(cw[i % len(cw)])
        dt = time.perf_counter() - t0
        ref.close()
        return n / dt
    except Exception as e:
        log({"reference_ldpc_bench_error": str(e)})
        return None


def bench_reference_bch(words, n=2048):
    """Reference C library BCH(15,5) decode, codewords/s (single core)."""
    sys.path.insert(0, "tests")
    try:
        import oracle

        if not oracle.available():
            return None
        ref = oracle.BCH()
        t0 = time.perf_counter()
        for i in range(n):
            ref.decode(int(words[i % len(words)]))
        dt = time.perf_counter() - t0
        ref.close()
        return n / dt
    except Exception as e:
        log({"reference_bch_bench_error": str(e)})
        return None


def bench_reference_rs(corrupt, parity, n=512):
    """Reference C library RS decode, codewords/s (single core)."""
    sys.path.insert(0, "tests")
    try:
        import oracle

        if not oracle.available():
            return None
        ref = oracle.RS()
        t0 = time.perf_counter()
        for i in range(n):
            ref.decode(corrupt[i % len(corrupt)], parity[i % len(parity)])
        dt = time.perf_counter() - t0
        ref.close()
        return n / dt
    except Exception as e:
        log({"reference_bench_error": str(e)})
        return None


def main():
    import jax

    if SMOKE:
        jax.config.update("jax_platforms", "cpu")

    import libpoporon_jax as pp
    from libpoporon_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not SMOKE:
        sys.exit(f"bench.py needs a GPU; found {dev.platform} "
                 f"({dev.device_kind}). POPORON_BENCH_SMOKE=1 runs it on the CPU.")
    log({"device": str(dev), "platform": dev.platform,
         "device_kind": dev.device_kind, "device_count": len(jax.devices())})

    rng = np.random.default_rng(0)

    # ---------------- RS(255,223) decode, 2 errors (primary) ----------------
    codec = pp.create(pp.rs_config_default())
    rs = codec._rs
    data = rng.integers(0, 256, (BATCH, 223), dtype=np.uint8)
    parity = np.asarray(rs.encode(data))
    corrupt = data.copy()
    pos = rng.integers(0, 223, (BATCH, 2))
    rows = np.arange(BATCH)
    corrupt[rows, pos[:, 0]] ^= 0x55
    corrupt[rows, pos[:, 1] % 223] ^= 0xAA

    dj = jax.device_put(corrupt)
    pj = jax.device_put(parity)
    dt = time_fn(lambda a, b: rs.decode(a, b), dj, pj)
    rs_dec_cws = BATCH / dt
    ok = np.asarray(rs.decode(dj, pj)[0])
    assert ok.all(), "bench decode failed"
    log({"bench": "rs_decode_2err", "codewords_per_s": rs_dec_cws})

    # ---------------- RS encode ----------------
    dt = time_fn(lambda a: rs._encode(a), jax.device_put(data))
    log({"bench": "rs_encode", "codewords_per_s": BATCH / dt})

    # ---------------- RS erasure decode (32 erasures) ----------------
    epos = np.sort(rng.choice(223, 32, replace=False)).astype(np.int32)
    eras = data.copy()
    for p in epos:
        eras[:, p] ^= 0xFF
    posb = np.broadcast_to(epos[None], (BATCH, 32)).copy()
    cnts = np.full(BATCH, 32, dtype=np.int32)
    ej, cj = jax.device_put(posb), jax.device_put(cnts)
    erj = jax.device_put(eras)
    dt = time_fn(lambda a, b, e, c: rs.decode(a, b, erasures=(e, c)),
                 erj, pj, ej, cj)
    log({"bench": "rs_erasure_32", "codewords_per_s": BATCH / dt})

    # ---------------- RS external-syndrome decode ----------------
    s_norm = np.asarray(rs._syndrome(dj, pj))
    s_log = np.asarray(jax.device_get(rs.gf.exp2log)).astype(np.int32)[s_norm]
    sj = jax.device_put(s_log)
    dt = time_fn(lambda a, b, s: rs.decode(a, b, ext_syndrome=s), dj, pj, sj)
    log({"bench": "rs_ext_syndrome", "codewords_per_s": BATCH / dt})

    # ---------------- BCH(15,5) batch ----------------
    # Production batch (131072): at B=10240 the row is dominated by
    # fixed per-call costs.
    bch = pp.create(pp.bch_config_default())._bch
    bch_n = BATCH
    # draw-stream compatibility: earlier versions drew exactly 10240
    # words from `rng` here, and every LATER row's random instance
    # depends on the stream position (the 8192B row is gated by its
    # single worst codeword).  Keep the historical 10240 draws and top
    # up to the production batch from a dedicated generator.
    words10 = rng.integers(0, 1 << 15, (10240,), dtype=np.int32)
    brng = np.random.default_rng(4321)
    words = np.concatenate([
        words10,
        brng.integers(0, 1 << 15, (bch_n - 10240,), dtype=np.int32),
    ]) if bch_n > 10240 else words10[:bch_n]
    wbits = ((words[:, None] >> np.arange(15)) & 1).astype(np.int32)
    wj = jax.device_put(wbits)
    dt = time_fn(lambda w: bch._decode_bits(w), wj)
    bch_cws = bch_n / dt
    log({"bench": "bch15_decode", "codewords_per_s": bch_cws, "batch": bch_n})

    # ---------------- LDPC rate-1/2 n=128B hard decode ----------------
    from libpoporon_jax.config import LdpcConfig, LdpcRate
    from libpoporon_jax.models.ldpc import LDPCCodec

    lc = LDPCCodec(LdpcConfig(block_size=128, rate=LdpcRate.RATE_1_2))
    info = rng.integers(0, 256, (LDPC_BATCH, lc.info_bytes), dtype=np.uint8)
    lp = np.asarray(lc.encode(info))
    cw = np.concatenate([info, lp], axis=1)
    # 4 distinct random bit flips per codeword (vectorized)
    fl = np.argsort(rng.random((LDPC_BATCH, lc.codeword_bits)), axis=1)[:, :4]
    rows4 = np.repeat(np.arange(LDPC_BATCH), 4)
    np.bitwise_xor.at(
        cw, (rows4, fl.reshape(-1) // 8),
        (1 << (7 - (fl.reshape(-1) % 8))).astype(np.uint8),
    )
    cwj = jax.device_put(cw)
    dt = time_fn(lambda c: lc._decode_hard(c, 50), cwj, warmup=2, iters=3)
    log({"bench": "ldpc_r12_128B_hard_4err_fixed", "codewords_per_s": LDPC_BATCH / dt,
         "mbit_per_s": LDPC_BATCH / dt * lc.codeword_bits / 1e6})
    dt = time_fn(lambda c: lc.decode_hard_adaptive(c, 50), cwj, warmup=2, iters=3)
    ldpc_cws = LDPC_BATCH / dt
    ldpc_mbits = ldpc_cws * lc.codeword_bits / 1e6
    log({"bench": "ldpc_r12_128B_hard_4err", "codewords_per_s": ldpc_cws,
         "mbit_per_s": ldpc_mbits})

    # ---------------- LDPC soft decode (~1e-2 channel BER) ----------------
    from libpoporon_jax.utils import bits as bitutils

    cb = bitutils.unpack_np(cw, lc.codeword_bits)
    clean = np.where(cb == 1, -90.0, 90.0)
    noisy = clean + rng.normal(0, 38.6, clean.shape)   # P(sign flip) ~ 1e-2
    llr = np.clip(np.round(noisy), -127, 127).astype(np.int8)
    ber = float((np.sign(noisy) != np.sign(clean)).mean())
    lj = jax.device_put(llr)
    dt = time_fn(lambda l: lc.decode_soft_adaptive(l, 50), lj, warmup=2, iters=3)
    log({"bench": "ldpc_r12_128B_soft_1e-2ber", "codewords_per_s": LDPC_BATCH / dt,
         "mbit_per_s": LDPC_BATCH / dt * lc.codeword_bits / 1e6,
         "channel_ber": round(ber, 5)})

    # ---------------- shipped presets (poporon.c:286-294) ----------------
    # default = both interleavers + soft-capable (the path users get
    # from ldpc_config_default); burst = cw=7 + both interleavers;
    # plus one QC-matrix row.  Facade-level decode, hard inputs.
    from libpoporon_jax.config import LdpcMatrixType

    # dedicated generator: consuming `rng` here would shift the draws
    # (error patterns, hence iteration tails) of every later row and
    # break round-over-round comparability of the big-block rows
    prng = np.random.default_rng(1234)
    preset_batch = 4096 if SMOKE else 65536
    for name, cfg in (
        ("ldpc_default_preset_128B",
         pp.ldpc_config_default(128, LdpcRate.RATE_1_2)),
        ("ldpc_burst_cw7_128B",
         pp.ldpc_config_burst_resistant(128, LdpcRate.RATE_1_2)),
        ("ldpc_qc_128B",
         LdpcConfig(block_size=128, rate=LdpcRate.RATE_1_2,
                    matrix_type=LdpcMatrixType.QC_RANDOM)),
    ):
        fac = pp.create(cfg)
        pinfo = prng.integers(0, 256, (preset_batch, fac.info_size),
                              dtype=np.uint8)
        enc = fac.encode(pinfo.copy())
        pd, ppar = np.asarray(enc.data), np.asarray(enc.parity)
        bad = pd.copy()
        bad[:, 11] ^= 0x20
        bad[:, 60] ^= 0x01
        bj, pj2 = jax.device_put(bad), jax.device_put(ppar)

        def run(a, b, fac=fac):
            r = fac.decode(a, b)
            # DecodeResult is not a pytree: return the fields so
            # block_until_ready really waits on the computation
            return (r.ok, r.data, r.parity, r.corrected)

        ok0 = np.asarray(run(bj, pj2)[0])
        assert ok0.all(), f"{name}: bench decode failed"
        dt = time_fn(run, bj, pj2, warmup=2, iters=3)
        cbits = fac._ldpc.codeword_bits
        log({"bench": name, "codewords_per_s": preset_batch / dt,
             "mbit_per_s": preset_batch / dt * cbits / 1e6})

    # ---------------- LDPC big blocks ----------------
    # Drop earlier rows' device buffers first: the 8192B decode
    # allocates multi-GB message tensors, and the preceding batches
    # would otherwise stay resident beside them.
    del dj, pj, erj, ej, cj, sj, wj, cwj, lj, bj, pj2

    for bs, rate, nb in ((1024, LdpcRate.RATE_1_2, 4096),
                         (8192, LdpcRate.RATE_1_3, 512)):
        nb = 64 if SMOKE else min(nb, LDPC_BATCH)
        lcb = LDPCCodec(LdpcConfig(block_size=bs, rate=rate))
        binfo = rng.integers(0, 256, (nb, lcb.info_bytes), dtype=np.uint8)
        bpar = np.asarray(lcb.encode(binfo))
        bcw = np.concatenate([binfo, bpar], axis=1)
        nerr = max(4, lcb.codeword_bits // 1638)  # ~flagship error density
        bfl = np.argsort(rng.random((nb, lcb.codeword_bits)), axis=1)[:, :nerr]
        rr = np.repeat(np.arange(nb), nerr)
        np.bitwise_xor.at(
            bcw, (rr, bfl.reshape(-1) // 8),
            (1 << (7 - (bfl.reshape(-1) % 8))).astype(np.uint8),
        )
        bj = jax.device_put(bcw)
        dt = time_fn(lambda c: lcb.decode_hard_adaptive(c, 50), bj,
                     warmup=2, iters=2)
        log({"bench": f"ldpc_r{rate.ratio[0]}{rate.ratio[0]+rate.ratio[1]}_{bs}B_hard",
             "codewords_per_s": nb / dt,
             "mbit_per_s": nb / dt * lcb.codeword_bits / 1e6})

    # ---------------- reference C library baseline ----------------
    ref_bch = bench_reference_bch(words[:2048])
    if ref_bch:
        log({"bench": "reference_bch15_decode", "codewords_per_s": ref_bch,
             "vs_ref": bch_cws / ref_bch})
    ref_ldpc = bench_reference_ldpc(cw[:256])
    if ref_ldpc:
        log({"bench": "reference_ldpc_hard_decode", "codewords_per_s": ref_ldpc,
             "vs_ref": ldpc_cws / ref_ldpc})
    ref_cws = bench_reference_rs(corrupt, parity)
    vs = rs_dec_cws / ref_cws if ref_cws else 0.0
    if ref_cws:
        log({"bench": "reference_rs_decode_2err", "codewords_per_s": ref_cws})

    print(json.dumps({
        "metric": "RS(255,223) decode codewords/s/chip (2 errors)",
        "value": round(rs_dec_cws, 1),
        "unit": "codewords/s",
        "vs_baseline": round(vs, 2),
    }), flush=True)


if __name__ == "__main__":
    main()
