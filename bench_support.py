"""Helpers shared by ``bench.py`` and ``chip_smoke.py``.

Both run on a GPU only: they time device work with ``block_until_ready``,
name the device every number was taken on, and keep JAX's persistent
compile cache where ``JAX_COMPILATION_CACHE_DIR`` says or, when it is not
set, at the fixed ``<repo>/.jax_cache`` (gitignored). The library itself
configures no cache.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def compile_cache_dir(environ=None, repo_root: str = REPO_ROOT):
    """The directory the program must configure, or ``None`` when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself)."""
    environ = os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(repo_root, ".jax_cache")


def configure_compile_cache():
    """Apply :func:`compile_cache_dir`; call before the first compile."""
    import jax

    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def device_info() -> dict:
    """``{"platform", "kind", "count"}`` of the default backend, as JAX
    reports them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


def require_gpu() -> dict:
    """:func:`device_info`, or ``SystemExit`` when the default device is not
    a GPU: there is no CPU fallback for a measurement."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {info['platform']!r}")
    return info


def gpu_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of each card (one line each)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or out.stderr.strip()


def blocked(fn):
    """``fn()`` with its device work finished."""
    import jax

    return jax.block_until_ready(fn())


def median_time(fn, repeats=3):
    """Median of ``repeats`` timings of ``fn`` run to completion."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        blocked(fn)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def steady_time(fn, target_s=1.0, max_repeats=256):
    """Time a repeat-loop scaled to >= ``target_s`` of steady work.

    Short calls are timed as ONE block of ``ceil(target / t1)`` back-to-back
    calls (the last one blocked); calls already >= target keep the
    median-of-3 convention. Returns ``(per_call_s, block_s, repeats)``.
    """
    t0 = time.perf_counter()
    blocked(fn)
    t1 = max(time.perf_counter() - t0, 1e-9)
    if t1 >= target_s:
        times = [t1]
        for _ in range(2):
            t0 = time.perf_counter()
            blocked(fn)
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        return med, med, 1
    reps = int(min(max_repeats, max(2, np.ceil(target_s / t1))))
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn()
    import jax

    jax.block_until_ready(out)
    block = time.perf_counter() - t0
    return block / reps, float(block), reps
