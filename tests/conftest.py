"""Test env: force CPU with 8 virtual devices BEFORE jax imports.

Tests exercise sharding/collectives on an 8-device CPU mesh (SURVEY §4.5)
and all math tests run on the CPU for determinism and speed; the forward
kernel runs there in the Pallas interpreter.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere. On a machine
with a card, ``FOURD_TEST_GPU=1`` leaves JAX on its default platform so
they run:

    FOURD_TEST_GPU=1 python -m pytest tests -m gpu -n 0
"""
import os

_USE_GPU = os.environ.get("FOURD_TEST_GPU") == "1"
if not _USE_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not _USE_GPU:
    jax.config.update("jax_platforms", "cpu")

from fourd_ray_tracing_tpu.utils.compile_cache import setup_compile_cache

setup_compile_cache()

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests where JAX has no GPU (decided per test,
    at run time, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with FOURD_TEST_GPU=1 on a card)")


@pytest.fixture
def rng_np():
    return np.random.default_rng(0)
