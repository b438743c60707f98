#!/usr/bin/env python3
"""On-chip smoke test: the main paths once on one GPU, through the entry
points a user calls, at the widths the benchmark uses.

    python chip_smoke.py            # one GPU, every phase
    python chip_smoke.py --four     # four GPUs: only the sharded paths

Phases (x64 off: the production float32 path):

1. device — a GPU or exit non-zero; card name and power limit; matmul
   precision in effect.
2. headline — the dim-16 cross-resonance 10k-member amplitude sweep through
   ``Solver.solve_sweep(method="fused_dopri5")`` (the Triton lockstep
   kernel), against host DOP853(1e-8); then the same sweep on the Triton
   kernel and on its XLA twin, side by side.
3. adaptive_grad — ``jax.grad`` through that sweep against host finite
   differences.
4. serving — 256 Gaussian schedules on the dim-27 three-transmon
   ``DynamicsBackend`` through ``backend.run`` -> counts, against DOP853(1e-12).
5. fixed_step — ``fused_sweep_solve`` (XLA engine) over 10k members and its
   gradient, against ``Solver.solve(method="jax_expm")``.
6. perturbative — Dyson and Magnus ``solve_sweep`` and the Monte-Carlo sweep.
7. large_dim — the dim-16 vectorized Lindblad sweep (solve_dim 256) on the
   polynomial engine, and the df32 sweep at dim 16 against DOP853(1e-12).

Each phase prints one line: compile seconds, one steady time (blocked with
``block_until_ready``), the maximum error with its tolerance and the reason,
and memory. Any failure ends the run with a non-zero exit and no final line.
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the 4-GPU sharded paths and their 1-GPU references")
    p.add_argument("--members", type=int, default=10000,
                   help="sweep members of the headline and fixed-step phases")
    p.add_argument("--phases", default="all",
                   help="comma-separated subset of the one-GPU phases (default: all)")
    return p.parse_args(argv)


class Phase:
    """Collects one phase's numbers and prints them as one line."""

    def __init__(self, name):
        self.name = name
        self.fields = {}
        self.t_start = time.perf_counter()

    def set(self, **kw):
        self.fields.update(kw)

    def check(self, label, err, tol, reason):
        self.fields[f"{label}_max_err"] = f"{err:.3e}"
        self.fields[f"{label}_tol"] = f"{tol:.1e} ({reason})"
        if not (np.isfinite(err) and err <= tol):
            raise AssertionError(
                f"{self.name}: {label} max error {err:.3e} exceeds {tol:.1e} ({reason})"
            )

    def emit(self):
        self.fields["phase_wall_s"] = f"{time.perf_counter() - self.t_start:.1f}"
        body = " ".join(f"{k}={v}" for k, v in self.fields.items())
        print(f"[{self.name}] {body}", flush=True)


def compiled_call(fn, *args, repeats=3):
    """Compile ``fn`` for ``args``; returns ``(out, compile_s, steady_s,
    memory_bytes)`` with the steady time the median of ``repeats`` blocked
    calls and memory the compiled program's argument + output + temp bytes."""
    import jax
    from bench_support import blocked, median_time

    lowered = jax.jit(fn).lower(*args)
    t0 = time.perf_counter()
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    mem_bytes = None
    if mem is not None:
        mem_bytes = int(
            mem.argument_size_in_bytes + mem.output_size_in_bytes + mem.temp_size_in_bytes
        )
    out = blocked(lambda: compiled(*args))
    steady = median_time(lambda: compiled(*args), repeats=repeats)
    return out, compile_s, steady, mem_bytes


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# shared model: the headline cross-resonance sweep


def cr_setup():
    from qiskit_dynamics_tpu import Signal
    from qiskit_dynamics_tpu.benchmarks import cr_solver

    solver, w1 = cr_solver(dim=4)  # dim 16
    y0 = np.zeros(16, dtype=complex)
    y0[0] = 1.0

    def signals_fn(amp):
        return [Signal(lambda t: amp * 0.02, carrier_freq=w1)]

    return solver, w1, y0, signals_fn


T_CR = 100.0
SWEEP_OPTS = dict(atol=1e-6, rtol=1e-6, h0=0.1)


def host_cr_populations(solver, w1, y0, amp, tol):
    from qiskit_dynamics_tpu import Signal

    r = solver.solve(
        t_span=[0.0, T_CR], y0=y0,
        signals=[Signal(lambda t, a=amp: a * 0.02, carrier_freq=w1)],
        method="DOP853", atol=tol, rtol=tol,
    )
    return np.abs(np.asarray(r.y[-1])) ** 2


def phase_headline(n_members):
    import jax.numpy as jnp
    from qiskit_dynamics_tpu.ops.adaptive_sweep import sweep_dopri5_lockstep_split
    from qiskit_dynamics_tpu.solvers.fused_sweep import adaptive_sweep_inputs

    ph = Phase("headline")
    solver, w1, y0, signals_fn = cr_setup()
    amps = jnp.linspace(0.25, 1.0, n_members)

    def sweep(a):
        return solver.solve_sweep(
            signals_fn, a, t_span=(0.0, T_CR), y0=y0, method="fused_dopri5", **SWEEP_OPTS
        )

    out, c_s, st_s, mem = compiled_call(sweep, amps)
    pops = np.abs(np.asarray(out)) ** 2
    ph.set(members=n_members, dim=16, compile_s=f"{c_s:.2f}", steady_s=f"{st_s:.4f}",
           sims_per_s=f"{n_members / st_s:.1f}", mem_bytes=mem)
    probes = np.linspace(0, n_members - 1, 16).astype(int)
    err = max(
        float(np.max(np.abs(pops[i] - host_cr_populations(solver, w1, y0, float(amps[i]), 1e-8))))
        for i in probes
    )
    ph.check("vs_dop853_pop", err, 1e-5, "BARS.md headline bar, 16 probes")

    # the same sweep on the Triton kernel and on its XLA twin (same inputs,
    # same grouping): both times, step counts, and their agreement
    args, statics, finish = adaptive_sweep_inputs(
        solver.model, signals_fn, amps, (0.0, T_CR), y0,
        rwa_signal_map=solver._rwa_signal_map,
    )
    results = {}
    for engine in ("triton", "xla"):
        def run(*a, engine=engine):
            out, rec = sweep_dopri5_lockstep_split(
                *a, **statics, **SWEEP_OPTS, record_steps=True, engine=engine
            )
            return finish(out), (rec > 0).sum(axis=1)

        (y, steps), c_e, st_e, mem_e = compiled_call(run, *args)
        results[engine] = (np.asarray(y), np.asarray(steps))
        ph.set(**{f"{engine}_compile_s": f"{c_e:.2f}", f"{engine}_steady_s": f"{st_e:.4f}",
                  f"{engine}_mem_bytes": mem_e,
                  f"{engine}_steps_min_mean_max":
                      f"{steps.min()}/{steps.mean():.1f}/{steps.max()}"})
    # f32 roundoff in the error estimates steers the two engines' step
    # sizes apart, so their states differ by up to the integration error;
    # the populations (the headline quantity) agree to the bar's class
    y_t, y_x = results["triton"][0], results["xla"][0]
    ph.set(triton_vs_xla_state_max_diff=f"{float(np.max(np.abs(y_t - y_x))):.3e}")
    diff = float(np.max(np.abs(np.abs(y_t) ** 2 - np.abs(y_x) ** 2)))
    ph.check("triton_vs_xla_pop", diff, 2e-5,
             "regrouped-tile tolerance; each engine is within 1e-5 of DOP853")
    ph.emit()


def phase_adaptive_grad(n_members):
    import jax
    import jax.numpy as jnp

    ph = Phase("adaptive_grad")
    solver, w1, y0, signals_fn = cr_setup()
    amps = jnp.linspace(0.25, 1.0, n_members)

    def loss(a):
        yf = solver.solve_sweep(
            signals_fn, a, t_span=(0.0, T_CR), y0=y0, method="fused_dopri5", **SWEEP_OPTS
        )
        return jnp.sum(jnp.abs(yf[:, 0]) ** 2)

    g, c_s, st_s, mem = compiled_call(jax.grad(loss), amps)
    g = np.asarray(g)
    ph.set(members=n_members, compile_s=f"{c_s:.2f}", steady_s=f"{st_s:.4f}",
           grad_sims_per_s=f"{n_members / st_s:.1f}", mem_bytes=mem)
    eps = 1e-4
    rel = 0.0
    for i in (n_members // 3, n_members - 1):
        a = float(amps[i])
        fd = (host_cr_populations(solver, w1, y0, a + eps, 1e-10)[0]
              - host_cr_populations(solver, w1, y0, a - eps, 1e-10)[0]) / (2 * eps)
        rel = max(rel, abs(g[i] - fd) / abs(fd))
    ph.check("vs_host_fd_rel", rel, 1e-2,
             "adjoint of the f32 tol-1e-6 integration on its recorded grid")
    ph.emit()


def phase_serving(n_sched=256):
    from bench_support import blocked, median_time
    from qiskit_dynamics_tpu.benchmarks import gaussian_amp_schedules, three_transmon_backend
    from qiskit_dynamics_tpu.ops.adaptive_sweep import lockstep_tile_b

    ph = Phase("serving")
    backend = three_transmon_backend()  # 3 transmons x 3 levels: dim 27
    shots = 1024
    backend.set_options(solver_options={"method": "fused_dopri5"}, shots=shots,
                        seed_simulator=7)
    scheds = gaussian_amp_schedules(np.linspace(0.05, 0.95, n_sched), duration=64)
    t0 = time.perf_counter()
    states = blocked(lambda: backend.solve(scheds))
    first_s = time.perf_counter() - t0
    steady = median_time(lambda: backend.run(scheds).result())
    counts = [backend.run(scheds).result().get_counts(i) for i in (0, n_sched - 1)]
    for c in counts:
        if sum(c.values()) != shots:
            raise AssertionError(f"serving: counts sum {sum(c.values())} != shots {shots}")
    ph.set(schedules=n_sched, dim=27, tile_b=lockstep_tile_b(27), first_call_s=f"{first_s:.2f}",
           run_steady_s=f"{steady:.4f}", schedules_per_s=f"{n_sched / steady:.1f}",
           counts_sum_ok=True, peak_bytes=peak_bytes())
    probes = [0, n_sched // 3, 2 * n_sched // 3, n_sched - 1]
    backend.set_options(solver_options={"method": "DOP853", "atol": 1e-12, "rtol": 1e-12})
    refs = backend.solve([scheds[i] for i in probes])
    backend.set_options(solver_options={"method": "fused_dopri5"})
    err = max(
        float(np.max(np.abs(np.asarray(states[i].y[-1]) - np.asarray(r.y[-1]))))
        for i, r in zip(probes, refs)
    )
    ph.check("vs_dop853_state", err, 1e-5, "BARS.md serving bar at the default tol 5e-8")
    ph.emit()


def phase_fixed_step(n_members):
    import jax
    import jax.numpy as jnp
    from qiskit_dynamics_tpu import Signal
    from qiskit_dynamics_tpu.solvers import fused_sweep_solve

    ph = Phase("fixed_step")
    solver, w1, y0, signals_fn = cr_setup()
    amps = jnp.linspace(0.25, 1.0, n_members)
    kw = dict(t_span=(0.0, T_CR), max_dt=0.5, y0=y0, rwa_signal_map=solver._rwa_signal_map)

    def pops(a):
        return jnp.abs(fused_sweep_solve(solver.model, signals_fn, a, **kw)) ** 2

    p, c_s, st_s, mem = compiled_call(pops, amps)
    p = np.asarray(p)
    ph.set(members=n_members, dim=16, compile_s=f"{c_s:.2f}", steady_s=f"{st_s:.4f}",
           sims_per_s=f"{n_members / st_s:.1f}", mem_bytes=mem)
    probes = np.linspace(0, n_members - 1, 4).astype(int)
    err = 0.0
    for i in probes:
        r = solver.solve(
            t_span=[0.0, T_CR], y0=y0,
            signals=[Signal(lambda t, a=float(amps[i]): a * 0.02, carrier_freq=w1)],
            method="jax_expm", max_dt=0.5, magnus_order=2, expm_method="taylor",
            expm_order=8, expm_squarings=0,
        )
        err = max(err, float(np.max(np.abs(p[i] - np.abs(np.asarray(r.y[-1])) ** 2))))
    ph.check("vs_jax_expm_pop", err, 5e-5,
             "two f32 evaluations of one polynomial: ~steps x eps x sqrt(dim)")

    def loss(a):
        return jnp.sum(pops(a)[:, 0])

    g, gc_s, gst_s, gmem = compiled_call(jax.grad(loss), amps)
    ph.set(grad_compile_s=f"{gc_s:.2f}", grad_steady_s=f"{gst_s:.4f}", grad_mem_bytes=gmem)
    # the loss is a sum of per-member terms: d loss / d a_i is member i's
    # own derivative, so difference member i's population (a difference of
    # the f32 sum over 10k members would drown in its rounding)
    f = jax.jit(pops)
    i = n_members // 2
    eps = 1e-2
    fd = (float(f(amps.at[i].add(eps))[i, 0]) - float(f(amps.at[i].add(-eps))[i, 0])) / (2 * eps)
    ph.check("grad_vs_fd_rel", abs(float(g[i]) - fd) / abs(fd), 1e-2,
             "f32 central difference of one member at eps 1e-2")
    ph.emit()


def phase_perturbative(B=2048, n_steps=1000, mc_members=64):
    import jax
    import jax.numpy as jnp
    from scipy.linalg import expm as scipy_expm
    from qiskit_dynamics_tpu import Signal
    from qiskit_dynamics_tpu.benchmarks import dyson_transmon_solver, magnus_transmon_solver
    from qiskit_dynamics_tpu.models import LindbladModel
    from qiskit_dynamics_tpu.solvers import (
        mc_expectation,
        solve_mc_trajectories_sweep,
        solve_ode,
    )

    ph = Phase("perturbative")
    dim = 10
    Tt = n_steps * 0.1
    sigma = Tt / 6.0
    y0 = np.zeros(dim, dtype=complex)
    y0[0] = 1.0
    amps = jnp.linspace(0.2, 1.0, B)
    nd = np.arange(dim)
    G1 = -1j * 2 * np.pi * 0.02 * (np.diag(np.sqrt(nd[1:]), 1) + np.diag(np.sqrt(nd[1:]), -1))
    for name, build in (("dyson", dyson_transmon_solver), ("magnus", magnus_transmon_solver)):
        ps, nu = build()

        def sigs(amp, nu=nu):
            return [Signal(lambda t: amp * jnp.exp(-((t - Tt / 2) ** 2) / (2 * sigma**2)),
                           carrier_freq=nu)]

        def run(a, ps=ps, sigs=sigs):
            return jnp.abs(ps.solve_sweep(0.0, n_steps, y0, sigs, a))

        out, c_s, st_s, mem = compiled_call(run, amps)
        out = np.asarray(out)
        G0 = -1j * (2 * np.pi * nu * np.diag(nd) + np.pi * (-0.33) * np.diag(nd * (nd - 1)))
        err = 0.0
        for i in np.linspace(0, B - 1, 3).astype(int):
            amp = float(amps[i])
            env = lambda t, amp=amp: amp * np.exp(-((t - Tt / 2) ** 2) / (2 * sigma**2))
            rhs = lambda t, y, env=env: (
                G0 + np.real(env(t) * np.exp(1j * 2 * np.pi * nu * t)) * G1
            ) @ y
            r = solve_ode(rhs, [0.0, Tt], y0, method="DOP853", atol=1e-12, rtol=1e-12)
            ref = scipy_expm(-Tt * G0) @ np.asarray(r.y[-1])
            err = max(err, float(np.max(np.abs(out[i] - np.abs(ref)))))
        ph.set(**{f"{name}_members": B, f"{name}_compile_s": f"{c_s:.2f}",
                  f"{name}_steady_s": f"{st_s:.4f}", f"{name}_mem_bytes": mem})
        ph.check(f"{name}_vs_dop853_amp", err, 1e-5, f"BARS.md {name} bar")

    Zq = np.diag([1.0, -1.0]).astype(complex)
    SMq = np.array([[0.0, 1.0], [0.0, 0.0]], dtype=complex)
    N_OP = np.diag([0.0, 1.0]).astype(complex)
    model = LindbladModel(static_hamiltonian=0.0 * Zq, dissipator_operators=[SMq])
    g_sweep = jnp.linspace(0.2, 0.9, mc_members)

    def mc_run(key):
        res = solve_mc_trajectories_sweep(
            model, (0.0, 2.0), np.array([0.0, 1.0], dtype=complex),
            signals_fn=lambda g: (None, [Signal(g)]), params=g_sweep, n_traj=256,
            key=key, n_steps=400, n_save=4,
        )
        return mc_expectation(res.states, N_OP)

    p, c_s, st_s, mem = compiled_call(mc_run, jax.random.PRNGKey(3))
    expected = np.exp(-np.outer(np.linspace(0, 2, 5), np.asarray(g_sweep)))
    sigma_mc = np.sqrt(np.maximum(expected * (1 - expected), 1e-12) / 256)
    z = float(np.max(np.abs(np.asarray(p) - expected) / sigma_mc))
    ph.set(mc_member_traj=mc_members * 256, mc_compile_s=f"{c_s:.2f}", mc_steady_s=f"{st_s:.4f}",
           mc_mem_bytes=mem)
    ph.check("mc_stat_z", z, 4.0, "BARS.md z-gate: estimator vs analytic decay")
    ph.emit()


def phase_large_dim(n_members, B=2048):
    import jax.numpy as jnp
    from qiskit_dynamics_tpu import Signal, Solver
    from qiskit_dynamics_tpu.models import LindbladModel
    from qiskit_dynamics_tpu.solvers import fused_sweep_solve

    ph = Phase("large_dim")
    d4 = 4
    a4 = np.diag(np.sqrt(np.arange(1, d4)), 1)
    N4 = np.diag(np.arange(d4, dtype=float))
    I4 = np.eye(d4)
    H0 = (
        2 * np.pi * 5.0 * np.kron(N4, I4) + np.pi * (-0.33) * np.kron(N4 @ (N4 - I4), I4)
        + 2 * np.pi * 5.1 * np.kron(I4, N4) + np.pi * (-0.33) * np.kron(I4, N4 @ (N4 - I4))
        + 2 * np.pi * 0.002 * (np.kron(a4.T, a4) + np.kron(a4, a4.T))
    )
    Hd = 2 * np.pi * 0.02 * np.kron(a4 + a4.T, I4)
    diss = [np.sqrt(0.005) * np.kron(a4, I4), np.sqrt(0.005) * np.kron(I4, a4)]
    lmodel = LindbladModel(static_hamiltonian=H0, hamiltonian_operators=[Hd],
                           static_dissipators=diss, rotating_frame=np.diag(H0),
                           vectorized=True)
    rho0 = np.zeros((16, 16), dtype=complex)
    rho0[1, 1] = 1.0
    amps = jnp.linspace(0.2, 1.0, B)
    sig = lambda amp: ([Signal(lambda t: amp, carrier_freq=5.1)], None)

    def run(a):
        return fused_sweep_solve(lmodel, sig, a, t_span=(0.0, 10.0), max_dt=0.08, y0=rho0,
                                 magnus_order=3, sweep_engine="poly")

    out, c_s, st_s, mem = compiled_call(run, amps)
    out = np.asarray(out)
    ref_solver = Solver(static_hamiltonian=H0, hamiltonian_operators=[Hd],
                        static_dissipators=diss, rotating_frame=np.diag(H0))
    err = 0.0
    for i in (0, B - 1):
        r = ref_solver.solve(
            t_span=[0.0, 10.0], y0=rho0,
            signals=[Signal(lambda t, a=float(amps[i]): a, carrier_freq=5.1)],
            method="DOP853", atol=1e-12, rtol=1e-12,
        )
        err = max(err, float(np.max(np.abs(out[i] - np.asarray(r.y[-1])))))
    ph.set(lindblad_members=B, solve_dim=256, lindblad_compile_s=f"{c_s:.2f}",
           lindblad_steady_s=f"{st_s:.4f}", lindblad_mem_bytes=mem)
    ph.check("lindblad256_vs_dop853", err, 2e-6, "BARS.md dim-256 bar")

    # df32 at dim 16: host-orchestrated (not one jit) — first call includes
    # compilation, memory is the device's peak
    from bench_support import blocked, median_time

    solver, w1, y0, signals_fn = cr_setup()
    df_amps = np.linspace(0.25, 1.0, n_members)
    kw = dict(t_span=(0.0, T_CR), max_dt=0.2, y0=y0, rwa_signal_map=solver._rwa_signal_map,
              precision="df32")
    t0 = time.perf_counter()
    df_out = blocked(lambda: fused_sweep_solve(solver.model, signals_fn, df_amps, **kw))
    first_s = time.perf_counter() - t0
    st = median_time(lambda: fused_sweep_solve(solver.model, signals_fn, df_amps, **kw))
    err = 0.0
    for i in np.linspace(0, n_members - 1, 3).astype(int):
        r = solver.solve(
            t_span=[0.0, T_CR], y0=y0,
            signals=[Signal(lambda t, a=df_amps[i]: a * 0.02, carrier_freq=w1)],
            method="DOP853", atol=1e-12, rtol=1e-12,
        )
        err = max(err, float(np.max(np.abs(df_out[i] - np.asarray(r.y[-1])))))
    ph.set(df32_members=n_members, df32_first_call_s=f"{first_s:.2f}",
           df32_steady_s=f"{st:.4f}", peak_bytes=peak_bytes())
    ph.check("df32_vs_dop853_state", err, 1e-8, "BARS.md 1e-8 bar")
    ph.emit()


# ---------------------------------------------------------------------------
# four cards


def _spread_over(arr, n):
    """The array's shards sit on ``n`` distinct devices."""
    devs = {s.device for s in arr.addressable_shards}
    if len(devs) != n:
        raise AssertionError(f"result spans {len(devs)} devices, expected {n}")


def phase_four_sweep(n_members):
    import jax
    import jax.numpy as jnp
    from qiskit_dynamics_tpu.parallel import data_mesh

    ph = Phase("four_data_sweep")
    solver, w1, y0, signals_fn = cr_setup()
    amps = jnp.linspace(0.25, 1.0, n_members)
    mesh = data_mesh(4)

    def sweep(a, mesh=None):
        return solver.solve_sweep(signals_fn, a, t_span=(0.0, T_CR), y0=y0,
                                  method="fused_dopri5", mesh=mesh, **SWEEP_OPTS)

    out, c_s, st_s, mem = compiled_call(lambda a: sweep(a, mesh), amps)
    _spread_over(out, 4)
    one = jax.device_put(amps, jax.devices()[0])
    ref, c1, st1, mem1 = compiled_call(sweep, one)
    # per-card bucketing regroups the lockstep groups, so the step grids
    # differ and the states drift apart by the integration (phase) error;
    # the populations, the headline quantity, agree to the bar's class
    out, ref = np.asarray(out), np.asarray(ref)
    ph.set(members=n_members, cards=4, compile_s=f"{c_s:.2f}", steady_s=f"{st_s:.4f}",
           mem_bytes=mem, one_card_compile_s=f"{c1:.2f}", one_card_steady_s=f"{st1:.4f}",
           vs_one_card_state_max_diff=f"{float(np.max(np.abs(out - ref))):.3e}")
    err = float(np.max(np.abs(np.abs(out) ** 2 - np.abs(ref) ** 2)))
    ph.check("vs_one_card_pop", err, 2e-5, "per-card regrouping of lockstep groups")
    ph.emit()


def _random_generators(shape, scale, seed):
    """Anti-Hermitian ``(..., n, n)`` complex64 generators of norm ~``scale``."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    a = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    a = 0.5j * (a + np.conj(np.swapaxes(a, -1, -2))) * (scale / np.sqrt(n))
    return a.astype(np.complex64)


def phase_four_scan():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from qiskit_dynamics_tpu.ops.expm import expm_taylor
    from qiskit_dynamics_tpu.parallel import (
        TIME_AXIS, make_mesh, propagator_scan, sharded_propagator_scan,
    )

    ph = Phase("four_time_scan")
    T, n = 8192, 16
    dev0 = jax.devices()[0]
    props = jax.jit(lambda g: expm_taylor(g))(
        jax.device_put(_random_generators((T, n, n), 0.1, 1), dev0)
    )
    mesh = make_mesh((4,), (TIME_AXIS,))
    spread = jax.device_put(props, NamedSharding(mesh, P(TIME_AXIS, None, None)))
    out, c_s, st_s, mem = compiled_call(
        lambda p: sharded_propagator_scan(p, mesh=mesh, axis_name=TIME_AXIS), spread
    )
    _spread_over(out, 4)
    ref, c1, st1, _ = compiled_call(propagator_scan, props)
    err = float(np.max(np.abs(np.asarray(out) - np.asarray(ref))))
    ph.set(steps=T, dim=n, cards=4, compile_s=f"{c_s:.2f}", steady_s=f"{st_s:.4f}",
           mem_bytes=mem, one_card_steady_s=f"{st1:.4f}")
    ph.check("vs_one_card", err, 1e-4,
             "f32 products of 8192 unitaries in another association order")
    ph.emit()


def phase_four_tensor():
    import jax
    from bench_support import blocked, median_time
    from qiskit_dynamics_tpu.benchmarks import expm_chain
    from qiskit_dynamics_tpu.parallel import MODEL_AXIS, make_mesh, tensor_expm_chain

    ph = Phase("four_model_expm_chain")
    T, n = 64, 256
    gens = _random_generators((T, n, n), 2.0, 2)
    y0 = np.eye(n, dtype=np.complex64)
    mesh = make_mesh((4,), (MODEL_AXIS,))
    t0 = time.perf_counter()
    out = blocked(lambda: tensor_expm_chain(gens, 0.1, y0, mesh, squarings=1))
    first_s = time.perf_counter() - t0
    st_s = median_time(lambda: tensor_expm_chain(gens, 0.1, y0, mesh, squarings=1))
    _spread_over(out, 4)
    dev0 = jax.devices()[0]
    ref, c1, st1, _ = compiled_call(
        lambda g, y: expm_chain(g, 0.1, y, squarings=1),
        jax.device_put(gens, dev0), jax.device_put(y0, dev0),
    )
    err = float(np.max(np.abs(np.asarray(out) - np.asarray(ref))))
    ph.set(steps=T, dim=n, cards=4, first_call_s=f"{first_s:.2f}", steady_s=f"{st_s:.4f}",
           one_card_steady_s=f"{st1:.4f}", peak_bytes=peak_bytes())
    ph.check("vs_one_card", err, 1e-4,
             "f32 unitary chain, row-split matmuls sum in another order")
    ph.emit()


def main(argv=None):
    args = parse_args(argv)
    import jax

    from bench_support import configure_compile_cache, gpu_name_and_power, require_gpu

    configure_compile_cache()
    info = require_gpu()
    import qiskit_dynamics_tpu  # noqa: F401  (pins the matmul precision)

    dev = Phase("device")
    dev.set(platform=info["platform"], kind=repr(info["kind"]), count=info["count"],
            matmul_precision=jax.config.jax_default_matmul_precision,
            x64=jax.config.jax_enable_x64)
    dev.emit()
    print(gpu_name_and_power(), flush=True)
    if jax.config.jax_enable_x64:
        raise SystemExit("x64 is enabled; the smoke runs the float32 production path")

    if args.four:
        if info["count"] < 4:
            raise SystemExit(f"--four needs 4 GPUs, found {info['count']}")
        phase_four_sweep(args.members)
        phase_four_scan()
        phase_four_tensor()
    else:
        phases = {
            "headline": lambda: phase_headline(args.members),
            "adaptive_grad": lambda: phase_adaptive_grad(args.members),
            "serving": phase_serving,
            "fixed_step": lambda: phase_fixed_step(args.members),
            "perturbative": phase_perturbative,
            "large_dim": lambda: phase_large_dim(args.members),
        }
        chosen = list(phases) if args.phases == "all" else args.phases.split(",")
        for name in chosen:
            phases[name]()
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    main()
