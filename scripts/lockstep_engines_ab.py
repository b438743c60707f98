#!/usr/bin/env python3
"""Time the lockstep-adaptive sweep on the Triton kernel and on its XLA twin.

End to end through ``Solver.solve_sweep(method="fused_dopri5")`` at the
headline shape (dim-16 cross-resonance, T=100, atol=rtol=1e-6, h0=0.1), for
several lockstep group sizes, in turns (triton, xla, xla, triton) within one
process on one GPU. Each line gives the steady time (median of 5 blocked
calls), the accepted-step counts per group, and the population error against
host DOP853(1e-8) on 16 probe members.

    python scripts/lockstep_engines_ab.py [--members 10000] [--tiles 16,32,64]
        [--warps 1,2,4]   # Triton warps per program (default: the kernel's choice)
        [--serving]       # time the dim-27 serving batch per group size instead
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--members", type=int, default=10000)
    p.add_argument("--tiles", default="16,32,64")
    p.add_argument("--warps", default="",
                   help="comma-separated Triton warp counts to time (Triton only)")
    p.add_argument("--serving", action="store_true",
                   help="time 256 dim-27 DynamicsBackend schedules per group size")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    from bench_support import configure_compile_cache, gpu_name_and_power, median_time, require_gpu

    configure_compile_cache()
    info = require_gpu()
    print(info, gpu_name_and_power(), flush=True)
    import chip_smoke as cs
    import qiskit_dynamics_tpu.ops.adaptive_sweep as asw

    if args.serving:
        serving(args.tiles, median_time)
        return

    solver, w1, y0, signals_fn = cs.cr_setup()
    amps = jnp.linspace(0.25, 1.0, args.members)
    probes = np.linspace(0, args.members - 1, 16).astype(int)
    refs = [cs.host_cr_populations(solver, w1, y0, float(amps[i]), 1e-8) for i in probes]
    default_engine = asw.lockstep_engine

    def measure(engine, tile_b):
        asw.lockstep_engine = lambda interpret=False: engine
        try:
            f = jax.jit(lambda a: solver.solve_sweep(
                signals_fn, a, t_span=(0.0, cs.T_CR), y0=y0, method="fused_dopri5",
                tile_b=tile_b, **cs.SWEEP_OPTS,
            ))
            out = jax.block_until_ready(f(amps))
        finally:
            asw.lockstep_engine = default_engine
        steady = median_time(lambda: f(amps), repeats=5)
        pops = np.abs(np.asarray(out)) ** 2
        err = max(float(np.max(np.abs(pops[i] - r))) for i, r in zip(probes, refs))
        return steady, err

    def steps(tile_b):
        from qiskit_dynamics_tpu.solvers.fused_sweep import adaptive_sweep_inputs

        a, st, _ = adaptive_sweep_inputs(
            solver.model, signals_fn, amps, (0.0, cs.T_CR), y0, tile_b=tile_b,
            rwa_signal_map=solver._rwa_signal_map,
        )
        _, rec = asw.sweep_dopri5_lockstep_split(
            *a, **st, **cs.SWEEP_OPTS, record_steps=True, engine="xla"
        )
        n = np.asarray((rec > 0).sum(axis=1))
        return f"{n.min()}/{n.mean():.1f}/{n.max()}"

    if args.warps:
        default_warps = asw._triton_warps
        for tile_b in [int(t) for t in args.tiles.split(",")]:
            warps = [int(x) for x in args.warps.split(",")]
            for w in warps + warps[::-1]:
                asw._triton_warps = lambda n_pad, tile_b, w=w: w
                jax.clear_caches()  # retrace the kernel with the new count
                try:
                    steady, err = measure("triton", tile_b)
                finally:
                    asw._triton_warps = default_warps
                print(f"engine=triton tile_b={tile_b} num_warps={w} "
                      f"members={args.members} steady_s={steady:.5f} "
                      f"sims_per_s={args.members / steady:.1f} pop_err={err:.3e}",
                      flush=True)
        return

    for tile_b in [int(t) for t in args.tiles.split(",")]:
        for engine in ("triton", "xla", "xla", "triton"):
            steady, err = measure(engine, tile_b)
            print(f"engine={engine} tile_b={tile_b} members={args.members} "
                  f"steady_s={steady:.5f} sims_per_s={args.members / steady:.1f} "
                  f"pop_err={err:.3e}", flush=True)
        print(f"tile_b={tile_b} accepted_steps_min/mean/max={steps(tile_b)}", flush=True)


def serving(tiles, median_time):
    """Steady ``backend.solve`` time of 256 Gaussian schedules on the dim-27
    three-transmon backend (Triton engine), per group size, in turns."""
    import time

    from bench_support import blocked
    from qiskit_dynamics_tpu.benchmarks import gaussian_amp_schedules, three_transmon_backend

    backend = three_transmon_backend()
    scheds = gaussian_amp_schedules(np.linspace(0.05, 0.95, 256), duration=64)
    tiles = [int(t) for t in tiles.split(",")]
    for tile_b in tiles + tiles[::-1]:
        backend.set_options(solver_options={"method": "fused_dopri5", "tile_b": tile_b})
        t0 = time.perf_counter()
        blocked(lambda: backend.solve(scheds))
        first = time.perf_counter() - t0
        steady = median_time(lambda: backend.solve(scheds), repeats=5)
        print(f"serving tile_b={tile_b} first_call_s={first:.2f} steady_s={steady:.4f} "
              f"schedules_per_s={256 / steady:.1f}", flush=True)


if __name__ == "__main__":
    main()
