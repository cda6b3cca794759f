"""Test harness config.

Per SURVEY.md §4.5 the tests run on the CPU backend with 8 virtual devices,
so the sharded path (parallel/) runs without several cards.  With
FLUID_TEST_DEVICE=gpu the card stays the backend instead: that is how the
on-card tier (tests/test_gpu.py, marker ``gpu``) runs, e.g. from
chip_smoke.py.  Env vars must be set before the first jax import.
"""

import os
import sys

import pytest

ON_CARD = os.environ.get("FLUID_TEST_DEVICE", "") == "gpu"

if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)

# persistent compilation cache (JAX_COMPILATION_CACHE_DIR when set)
from gpufluidsimulator_tpu.utils import cache  # noqa: E402

cache.enable()


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (the on-card tier)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `FLUID_TEST_DEVICE=gpu python -m "
                    "pytest tests/test_gpu.py -m gpu` on the card")
