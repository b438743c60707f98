"""Unit tests for the benchmark harness helpers (no device work).

``bench_support`` is shared by ``bench.py`` and ``chip_smoke.py``: its
compile-cache rule, device guard and steady-timing behavior are locked here.
"""
import os
import time

import numpy as np
import pytest

import bench_support


class TestSteadyTime:
    def test_scales_repeats_to_target_block(self):
        per, block, reps = bench_support.steady_time(
            lambda: time.sleep(0.01), target_s=0.1, max_repeats=64
        )
        assert reps >= 2
        assert block >= 0.1
        assert per == pytest.approx(block / reps)

    def test_long_call_uses_median_of_three(self):
        per, block, reps = bench_support.steady_time(
            lambda: time.sleep(0.05), target_s=0.01
        )
        assert reps == 1
        assert per == block
        assert per >= 0.05


class TestChipProbeConstants:
    def test_median_time_is_median(self):
        durations = iter([0.0, 0.0, 0.0])
        t = bench_support.median_time(lambda: next(durations, None), repeats=3)
        assert t >= 0.0
        assert np.isfinite(t)


class TestCompileCacheRule:
    def test_env_set_means_no_cache_in_code(self):
        env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}
        assert bench_support.compile_cache_dir(env, repo_root="/r") is None

    @pytest.mark.parametrize("env", [{}, {"JAX_COMPILATION_CACHE_DIR": ""}])
    def test_env_unset_uses_repo_cache(self, env):
        assert bench_support.compile_cache_dir(env, repo_root="/r") == os.path.join(
            "/r", ".jax_cache"
        )

    def test_default_root_is_the_checkout(self):
        path = bench_support.compile_cache_dir({})
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")

    def test_bench_import_leaves_jax_config_alone(self):
        import jax

        before = jax.config.jax_compilation_cache_dir
        import bench  # noqa: F401

        assert jax.config.jax_compilation_cache_dir == before


class TestDeviceGuard:
    def test_device_info_keys(self):
        info = bench_support.device_info()
        assert set(info) == {"platform", "kind", "count"}
        assert info["count"] >= 1

    def test_require_gpu_refuses_the_cpu(self):
        # the suite runs on the CPU: a measurement must not fall back to it
        with pytest.raises(SystemExit, match="no GPU"):
            bench_support.require_gpu()
