"""Test configuration.

By default the suite runs on the CPU with 8 virtual devices, so the
multi-device sharding paths (jax.sharding.Mesh + shard_map) are
exercised without a GPU.  When ``JAX_PLATFORMS`` names the GPU
(``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``), the GPU stays
the default device and the CPU backend is kept beside it, so the
``gpu``-marked tests can compare the card with the CPU.
"""

import os

import pytest

_platforms = [p for p in os.environ.get("JAX_PLATFORMS", "").split(",") if p]
ON_GPU = any(p in ("cuda", "gpu") for p in _platforms)

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if ON_GPU:
    if "cpu" not in _platforms:
        jax.config.update("jax_platforms", ",".join(_platforms + ["cpu"]))
else:
    jax.config.update("jax_platforms", "cpu")

from libpoporon_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return gpus[0]
