#!/usr/bin/env bash
# CI harness — the analogue of the reference's ci.sh
# (/root/reference/ci.sh:5-56, which loops Debug/Release x
# ASAN/UBSAN/MSAN x Valgrind x WASM).  The equivalents here:
#
#   1. build the native host core (C++) fresh and the C oracle
#   2. byte-compile every Python source (syntax/lint gate)
#   3. full pytest suite on the 8-virtual-device CPU mesh (the
#      multi-device sharding path) — includes the oracle bit-exactness
#      suite, the moral equivalent of the sanitizer matrix: every data
#      path is checked value-identical against the untouched C library
#   4. multi-device dry-run (mesh compile + one sharded step)
#   5. bench smoke run (tiny batches on the CPU)
#
# Usage:
#   ./ci.sh              # CPU CI
#   CI_GPU=1 ./ci.sh     # additionally run chip_smoke.py on the GPU: every
#                        # codec phase bit-exact against the CPU backend,
#                        # after the gpu-marked tests
set -euo pipefail
cd "$(dirname "$0")"

echo "=== [1/5] native core + oracle build ==="
make -C libpoporon_jax/native clean >/dev/null
make -C libpoporon_jax/native
python - <<'EOF'
from libpoporon_jax.utils import native
assert native.available(), "native core failed to load"
import sys; sys.path.insert(0, "tests")
import oracle
assert oracle.available(), "reference oracle failed to build"
print("native core + oracle: ok")
EOF

echo "=== [2/5] lint (byte-compile all sources) ==="
python -m compileall -q libpoporon_jax tests benchmarks bench.py chip_smoke.py __graft_entry__.py
echo "compileall: ok"

echo "=== [3/5] pytest (8-device virtual CPU mesh) ==="
JAX_PLATFORMS=cpu python -m pytest tests/ -q

echo "=== [4/5] multi-device dry-run ==="
JAX_PLATFORMS=cpu XLA_FLAGS="${XLA_FLAGS:-} --xla_force_host_platform_device_count=8" \
python - <<'EOF'
import __graft_entry__ as g
g.dryrun_multichip(8)
print("dryrun_multichip(8): ok")
EOF

echo "=== [5/5] bench smoke ==="
POPORON_BENCH_SMOKE=1 python bench.py >/dev/null
echo "bench smoke: ok"

if [[ "${CI_GPU:-0}" != "0" ]]; then
  echo "=== [gpu] chip_smoke.py ==="
  python chip_smoke.py
fi

echo "CI: all green"
