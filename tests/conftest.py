"""Test configuration.

Tests run on CPU with 8 virtual devices (to exercise multi-device sharding
paths without GPUs) and 64-bit precision enabled (so numerical agreement with
scipy ground truths can be asserted at 1e-8, matching the test bar of upstream
qiskit-dynamics in test/dynamics/common.py).
"""
import os

# ``QDT_TEST_GPU=1`` keeps JAX's default (GPU) platform so that the tests
# marked ``gpu`` can run on the card: ``QDT_TEST_GPU=1 python -m pytest -m gpu
# tests/``. Whether a GPU is present is decided inside those tests' fixture.
ON_GPU = os.environ.get("QDT_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import pytest

if not ON_GPU:
    # jax may already be imported (with another platform) before this file
    # runs; tests run on the virtual 8-device CPU mesh, so override via config
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled-executable references after each test module.

    Every XLA CPU executable holds mmap'd code; a full-suite process
    accumulates compilations past ``vm.max_map_count`` (default 65530) and
    segfaults inside ``backend_compile_and_load`` near the END of the run
    (observed twice at ~99%, in unrelated compiles). Clearing per module
    bounds the map count at the cost of cross-module recompiles.
    """
    yield
    jax.clear_caches()
