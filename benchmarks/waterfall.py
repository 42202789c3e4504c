"""BER waterfall evaluation for the LDPC soft decoder.

Sweeps Eb/N0 (SNR) over an AWGN/BPSK channel and reports raw channel
BER vs post-decode BER/FER per point — the standard way to evaluate an
FEC code + decoder pair.  The reference C library ships no such tool;
this one runs the whole sweep as batched device programs.

Usage:
    python benchmarks/waterfall.py [--block 128] [--rate 1/2]
        [--batch 4096] [--snrs 2.0,2.5,...] [--iters 50] [--soft/--hard]

Prints one JSON line per SNR point:
    {"snr_db": 3.0, "raw_ber": ..., "ber": ..., "fer": ..., "avg_iters": ...}
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


RATES = {
    "1/3": "RATE_1_3", "1/2": "RATE_1_2", "2/3": "RATE_2_3",
    "3/4": "RATE_3_4", "4/5": "RATE_4_5", "5/6": "RATE_5_6",
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--rate", default="1/2", choices=sorted(RATES))
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--snrs", default="2.0,2.5,3.0,3.5,4.0,4.5,5.0")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--hard", action="store_true",
                    help="hard-decision decode of the sliced channel bits")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from libpoporon_jax.config import LdpcConfig, LdpcRate
    from libpoporon_jax.models.ldpc import LDPCCodec
    from libpoporon_jax.utils import bits as bitutils
    from libpoporon_jax.utils.faults import awgn_llrs
    from libpoporon_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    codec = LDPCCodec(
        LdpcConfig(block_size=args.block, rate=getattr(LdpcRate, RATES[args.rate]))
    )
    rng = np.random.default_rng(args.seed)
    B = args.batch
    info = rng.integers(0, 256, (B, codec.info_bytes), dtype=np.uint8)
    parity = np.asarray(codec.encode(info))
    cw = np.concatenate([info, parity], axis=1)
    cb = bitutils.unpack_np(cw, codec.codeword_bits)
    info_bits_ref = cb[:, : codec.info_bits]

    for snr_s in args.snrs.split(","):
        snr = float(snr_s)
        llr = awgn_llrs(cb, snr_db=snr, rng=int(rng.integers(1 << 31)))
        raw_ber = float(((llr < 0).astype(np.uint8) != cb).mean())
        if args.hard:
            hard_bits = (llr < 0).astype(np.uint8)
            cw_in = bitutils.pack_np(hard_bits)
            ok, out, iters = codec.decode_hard_adaptive(cw_in, args.iters)
        else:
            ok, out, iters = codec.decode_soft_adaptive(llr, args.iters)
        out_bits = bitutils.unpack_np(np.asarray(out), codec.codeword_bits)
        ber = float((out_bits[:, : codec.info_bits] != info_bits_ref).mean())
        fer = float((~np.asarray(ok)).mean())
        print(json.dumps({
            "snr_db": snr,
            "raw_ber": round(raw_ber, 6),
            "ber": round(ber, 8),
            "fer": round(fer, 6),
            "avg_iters": round(float(np.asarray(iters).mean()), 2),
        }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
