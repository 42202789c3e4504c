"""The persistent compile cache goes where JAX_COMPILATION_CACHE_DIR
says, and otherwise to <checkout>/.jax_cache."""

import os
import subprocess
import sys
from pathlib import Path

from libpoporon_jax.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import jax, jax.numpy as jnp
from libpoporon_jax.utils.compile_cache import enable_compile_cache
print(enable_compile_cache())
print(jax.config.jax_compilation_cache_dir)
jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()
"""


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop(compile_cache.ENV_VAR, None)
    if env_dir is not None:
        env[compile_cache.ENV_VAR] = str(env_dir)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split()[:2]


def test_default_is_checkout_jax_cache():
    assert compile_cache.DEFAULT_DIR == ROOT / ".jax_cache"
    used, configured = _probe(None)
    assert used == configured == str(ROOT / ".jax_cache")


def test_env_var_wins_and_receives_entries(tmp_path):
    used, configured = _probe(tmp_path)
    assert used == configured == str(tmp_path)
    assert any(tmp_path.iterdir())
