"""Tracing / throughput metrics.

The reference library has no profiling hooks (SURVEY.md §5); here they
are first-class: jax.profiler trace capture plus per-kernel
codewords/s / Mbit/s meters.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class ThroughputMeter:
    """Measures steady-state throughput of a jitted codec call.

    meter = ThroughputMeter(codewords_per_call=B, bits_per_codeword=n)
    stats = meter.measure(lambda: codec.decode(data, parity))
    """

    def __init__(self, codewords_per_call: int, bits_per_codeword: int = 0):
        self.codewords = codewords_per_call
        self.bits = bits_per_codeword

    def measure(self, fn, warmup: int = 2, iters: int = 5) -> dict:
        for _ in range(warmup):
            out = fn()
            jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        stats = {
            "seconds_per_call": dt,
            "codewords_per_s": self.codewords / dt,
        }
        if self.bits:
            stats["mbit_per_s"] = self.codewords * self.bits / dt / 1e6
        return stats
