"""Headline benchmark: CR-gate amplitude-sweep throughput on one GPU.

10k-point amplitude sweep of a two-transmon cross-resonance ``Solver``
(dim=16, rotating frame + RWA) through the lockstep-adaptive dopri5 engine
(``ops/adaptive_sweep.py``), compared against single-core NumPy/SciPy DOP853
(the reference's default solve path) at matched physics accuracy, followed
by the other rows (df32, Chebyshev, gradients, serving, Lindblad, expm
chain, perturbative and Monte-Carlo sweeps). Runs on a GPU only; every
device call is timed to completion with ``block_until_ready``.

Prints ONE JSON line:
``{"metric": ..., "value": N, "unit": "sims/sec", "vs_baseline": N, "device": {...}}``
"""
import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from bench_support import (
    blocked,
    configure_compile_cache,
    gpu_name_and_power,
    median_time,
    require_gpu,
    steady_time,
)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main():
    configure_compile_cache()
    device = require_gpu()
    log(f"device: {device}; {gpu_name_and_power()}")

    from qiskit_dynamics_tpu.benchmarks import cr_solver
    from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve
    from qiskit_dynamics_tpu import Signal, Solver

    sweep_size = int(os.environ.get("BENCH_SWEEP_SIZE", "10000"))
    n_baseline = int(os.environ.get("BENCH_BASELINE_POINTS", "3"))
    log(f"sweep={sweep_size}")

    solver, w1 = cr_solver()
    dim = 16
    y0 = np.zeros(dim, dtype=complex)
    y0[0] = 1.0
    T = 100.0
    amp_scale = 0.02

    def signals_fn(amp):
        return [Signal(lambda t: amp * amp_scale, carrier_freq=w1)]

    sweep = jax.jit(
        lambda a: jnp.abs(
            fused_adaptive_sweep_solve(
                solver.model, signals_fn, a, t_span=(0.0, T), y0=y0,
                atol=1e-6, rtol=1e-6, h0=0.1,
                rwa_signal_map=solver._rwa_signal_map,
            )
        )
        ** 2
    )
    amps = jnp.linspace(0.25, 1.0, sweep_size)

    t0 = time.time()
    out = blocked(lambda: (sweep(amps)))
    log(f"compile+first run: {time.time() - t0:.1f}s")

    steady, cr_block_s, cr_reps = steady_time(lambda: (sweep(amps)))
    device_throughput = sweep_size / steady
    log(f"device: {steady:.3f}s/call ({cr_reps} calls, {cr_block_s:.2f}s block) "
        f"for {sweep_size} sims -> {device_throughput:.1f} sims/sec")

    # single-core NumPy/SciPy DOP853 baseline at matched accuracy, extrapolated
    check_idx = np.linspace(0, sweep_size - 1, n_baseline).astype(int)
    check_amps = np.asarray(amps)[check_idx]
    t0 = time.time()
    base_results = []
    for a in check_amps:
        r = solver.solve(
            t_span=[0.0, T],
            y0=y0,
            signals=[Signal(lambda t, a=a: a * amp_scale, carrier_freq=w1)],
            method="DOP853",
            atol=1e-8,
            rtol=1e-8,
        )
        base_results.append(np.abs(np.asarray(r.y[-1])) ** 2)
    numpy_time = (time.time() - t0) / n_baseline
    numpy_throughput = 1.0 / numpy_time
    log(f"numpy DOP853: {numpy_time:.3f}s/sim -> {numpy_throughput:.2f} sims/sec")

    # accuracy at the probe points (reuses the compiled 10k sweep's outputs)
    max_err = float(np.max(np.abs(out[check_idx] - np.asarray(base_results))))
    log(f"max |device - DOP853(1e-8)| over {n_baseline} probe points: {max_err:.2e}")
    headline_extra = {
        "cr_sweep_max_err": float(f"{max_err:.3g}"),
        "cr_sweep_steady_s": round(cr_block_s, 3),
        "cr_sweep_repeats": cr_reps,
    }

    # --- high-precision row: df32 sweep at the BASELINE 1e-8 agreement bar ---
    # (compensated double-float32, Magnus order-6; ops/df_sweep.py)
    df_metrics = {}
    if os.environ.get("BENCH_DF32", "1") == "1":
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        df_sweep_size = int(os.environ.get("BENCH_DF32_SWEEP_SIZE", str(sweep_size)))
        df_amps = np.linspace(0.25, 1.0, df_sweep_size)
        df_kwargs = dict(
            t_span=(0.0, T), max_dt=0.2, y0=y0,
            rwa_signal_map=solver._rwa_signal_map, precision="df32",
        )
        t0 = time.time()
        df_out = blocked(
            lambda: fused_sweep_solve(solver.model, signals_fn, df_amps, **df_kwargs)
        )
        log(f"df32 compile+first run: {time.time() - t0:.1f}s")
        df_time = median_time(
            lambda: fused_sweep_solve(solver.model, signals_fn, df_amps, **df_kwargs)
        )
        df_throughput = df_sweep_size / df_time
        log(f"df32 device: {df_time:.2f}s (median of 3) for {df_sweep_size} sims -> {df_throughput:.1f} sims/sec")

        df_idx = np.linspace(0, df_sweep_size - 1, n_baseline).astype(int)
        df_err = 0.0
        for i in df_idx:
            r = solver.solve(
                t_span=[0.0, T], y0=y0,
                signals=[Signal(lambda t, a=df_amps[i]: a * amp_scale, carrier_freq=w1)],
                method="DOP853", atol=1e-12, rtol=1e-12,
            )
            df_err = max(df_err, float(np.max(np.abs(df_out[i] - np.asarray(r.y[-1])))))
        log(f"df32 max |state - DOP853(1e-12)| over {n_baseline} probes: {df_err:.2e}")
        df_metrics = {
            "df32_throughput": round(df_throughput, 2),
            "df32_vs_baseline": round(df_throughput / numpy_throughput, 2),
            "df32_max_err": float(f"{df_err:.3g}"),
        }

        # Gaussian-envelope df32 row: exercises the rank-1 profile
        # factorization (fixed pulse shape, member-scaled amplitudes —
        # the table assembles on device instead of being sampled on host)
        try:
            def gauss_signals_fn(amp):
                return [
                    Signal(
                        lambda t: amp
                        * amp_scale
                        * np.exp(-((t - T / 2) ** 2) / (T**2 / 12.5)),
                        carrier_freq=w1,
                    )
                ]

            t0 = time.time()
            dg_out = blocked(lambda: fused_sweep_solve(
                solver.model, gauss_signals_fn, df_amps, **df_kwargs
            ))
            log(f"df32-gauss compile+first: {time.time() - t0:.1f}s")
            dg_time = median_time(
                lambda: fused_sweep_solve(
                    solver.model, gauss_signals_fn, df_amps, **df_kwargs
                )
            )
            dg_err = 0.0
            for i in df_idx[:2]:
                r = solver.solve(
                    t_span=[0.0, T], y0=y0,
                    signals=gauss_signals_fn(float(df_amps[i])),
                    method="DOP853", atol=1e-12, rtol=1e-12,
                )
                dg_err = max(
                    dg_err, float(np.max(np.abs(dg_out[i] - np.asarray(r.y[-1]))))
                )
            log(
                f"df32-gauss steady (median of 3): {dg_time:.2f}s -> "
                f"{df_sweep_size / dg_time:.0f} sims/s, max err {dg_err:.2e}"
            )
            df_metrics["df32_gauss_throughput"] = round(df_sweep_size / dg_time, 1)
            df_metrics["df32_gauss_max_err"] = float(f"{dg_err:.3g}")
        except Exception as exc:
            log(f"df32-gauss row failed: {exc!r}")

    # --- chebyshev row: certified interpolated sweep (1e-8-class accuracy
    # at fused speed; sweep-LEVEL algorithm — solves ~tens of nodes with the
    # df32 engine and reconstructs all points; solvers/sweep_interpolation) ---
    cheb_metrics = {}
    if os.environ.get("BENCH_CHEB", "1") == "1":
        try:
            from qiskit_dynamics_tpu.solvers import interpolated_sweep_solve

            cheb_amps = np.linspace(0.25, 1.0, sweep_size)
            cheb_kwargs = dict(
                t_span=(0.0, T), y0=y0, tol=1e-9, min_level=4,
                rwa_signal_map=solver._rwa_signal_map, max_dt=0.2,
                full_output=True,
            )
            t0 = time.time()
            cheb_out, cheb_info = blocked(lambda: interpolated_sweep_solve(
                solver.model, signals_fn, cheb_amps, **cheb_kwargs
            ))
            log(f"cheb compile+first: {time.time() - t0:.1f}s "
                f"(nodes={cheb_info.n_nodes}, certified {cheb_info.est_error:.1e})")
            cheb_time = median_time(
                lambda: interpolated_sweep_solve(
                    solver.model, signals_fn, cheb_amps, **cheb_kwargs
                )
            )
            cheb_tp = sweep_size / cheb_time
            log(f"cheb steady (median of 3): {cheb_time:.2f}s -> {cheb_tp:.0f} sims/s")
            cheb_err = 0.0
            for i in np.linspace(0, sweep_size - 1, n_baseline).astype(int):
                r = solver.solve(
                    t_span=[0.0, T], y0=y0,
                    signals=[Signal(lambda t, a=cheb_amps[i]: a * amp_scale, carrier_freq=w1)],
                    method="DOP853", atol=1e-12, rtol=1e-12,
                )
                cheb_err = max(cheb_err, float(np.max(np.abs(cheb_out[i] - np.asarray(r.y[-1])))))
            log(f"cheb max |state - DOP853(1e-12)| over {n_baseline} probes: {cheb_err:.2e}")
            cheb_metrics = {
                "cheb_sweep_throughput": round(cheb_tp, 1),
                "cheb_vs_baseline": round(cheb_tp / numpy_throughput, 1),
                "cheb_max_err": float(f"{cheb_err:.3g}"),
                "cheb_nodes": int(cheb_info.n_nodes),
            }
        except Exception as exc:  # never let a row kill the bench JSON
            log(f"cheb row failed: {exc!r}")

    # --- 2-d calibration map row: anisotropic tensor-Chebyshev over an
    # amplitude x drive-detuning product grid (100 x 100 = 10k points) ---
    if os.environ.get("BENCH_CHEB2D", "1") == "1":
        try:
            from qiskit_dynamics_tpu.solvers import interpolated_sweep_solve_2d

            def map_fn(pq):
                amp, det = pq
                return [Signal(lambda t: amp * amp_scale, carrier_freq=w1 + det)]

            map_amps = np.linspace(0.25, 1.0, 100)
            map_dets = np.linspace(-0.002, 0.002, 100)
            map_kwargs = dict(
                t_span=(0.0, T), y0=y0, tol=1e-9, min_level=3, max_level=7,
                rwa_signal_map=solver._rwa_signal_map, max_dt=0.2,
                full_output=True,
            )
            t0 = time.time()
            map_out, map_info = blocked(lambda: interpolated_sweep_solve_2d(
                solver.model, map_fn, (map_amps, map_dets), **map_kwargs
            ))
            log(f"cheb2d compile+first: {time.time() - t0:.1f}s (nodes="
                f"{map_info.n_nodes}, levels={map_info.levels}, "
                f"certified {map_info.est_error:.1e})")
            map_time = median_time(
                lambda: interpolated_sweep_solve_2d(
                    solver.model, map_fn, (map_amps, map_dets), **map_kwargs
                )
            )
            n_map = map_amps.size * map_dets.size
            log(f"cheb2d steady (median of 3): {map_time:.2f}s -> "
                f"{n_map / map_time:.0f} sims/s")
            map_err = 0.0
            for i, j in ((0, 0), (50, 50), (99, 99)):
                r = solver.solve(
                    t_span=[0.0, T], y0=y0,
                    signals=map_fn((map_amps[i], map_dets[j])),
                    method="DOP853", atol=1e-12, rtol=1e-12,
                )
                map_err = max(map_err, float(np.max(np.abs(map_out[i, j] - np.asarray(r.y[-1])))))
            log(f"cheb2d max |map - DOP853(1e-12)| over 3 probes: {map_err:.2e}")
            cheb_metrics.update(
                cheb2d_map_throughput=round(n_map / map_time, 1),
                cheb2d_nodes=int(map_info.n_nodes),
                cheb2d_max_err=float(f"{map_err:.3g}"),
            )
        except Exception as exc:
            log(f"cheb2d row failed: {exc!r}")

    # --- gradient row: whole-sweep gradient through the fixed-step XLA
    # engine (reverse-mode AD through its checkpointed scan) ---
    grad_metrics = {}
    if os.environ.get("BENCH_GRAD", "1") == "1":
        try:
            from qiskit_dynamics_tpu.solvers import fused_sweep_solve

            def grad_loss(amps_in):
                yf = fused_sweep_solve(
                    solver.model, signals_fn, amps_in, t_span=(0.0, T),
                    max_dt=0.5, y0=y0, rwa_signal_map=solver._rwa_signal_map,
                )
                return jnp.mean(jnp.abs(yf[:, 1]) ** 2)

            gradfn = jax.jit(jax.grad(grad_loss))
            g_amps = jnp.linspace(0.25, 1.0, sweep_size)
            t0 = time.time()
            blocked(lambda: (gradfn(g_amps)))
            log(f"grad compile+first: {time.time() - t0:.1f}s")
            grad_time = median_time(lambda: (gradfn(g_amps)))
            log(
                f"grad steady (median of 3): {grad_time:.2f}s for {sweep_size}-point sweep "
                f"-> {sweep_size / grad_time:.0f} grad-sims/s"
            )
            grad_metrics = {"grad_sims_per_sec": round(sweep_size / grad_time, 1)}
        except Exception as exc:  # never let the grad row kill the bench JSON
            log(f"grad row failed: {exc!r}")

        # adaptive-kernel gradient (recorded-grid replay adjoint): gradients
        # at adaptive-primal accuracy through the headline solver
        try:
            def adgrad_loss(amps_in):
                yf = fused_adaptive_sweep_solve(
                    solver.model, signals_fn, amps_in, t_span=(0.0, T), y0=y0,
                    atol=1e-6, rtol=1e-6, h0=0.1,
                    rwa_signal_map=solver._rwa_signal_map,
                )
                return jnp.mean(jnp.abs(yf[:, 1]) ** 2)

            adgradfn = jax.jit(jax.grad(adgrad_loss))
            t0 = time.time()
            blocked(lambda: (adgradfn(g_amps)))
            log(f"adaptive-grad compile+first: {time.time() - t0:.1f}s")
            adgrad_time = median_time(lambda: (adgradfn(g_amps)))
            log(
                f"adaptive-grad steady (median of 3): {adgrad_time:.2f}s "
                f"-> {sweep_size / adgrad_time:.0f} grad-sims/s"
            )
            grad_metrics["adaptive_grad_sims_per_sec"] = round(
                sweep_size / adgrad_time, 1
            )
        except Exception as exc:
            log(f"adaptive-grad row failed: {exc!r}")

    # --- config-5 row: 3-transmon schedule batch through the fused kernel ---
    sched_metrics = {}
    if os.environ.get("BENCH_SCHEDULES", "1") == "1":
        from qiskit_dynamics_tpu.benchmarks import (
            gaussian_amp_schedules,
            three_transmon_backend,
        )

        n_sched = int(os.environ.get("BENCH_SCHEDULES_N", "256"))
        backend = three_transmon_backend()
        backend.set_options(solver_options={"method": "fused_dopri5"})
        scheds = gaussian_amp_schedules(np.linspace(0.05, 0.95, n_sched), duration=64)
        t0 = time.time()
        blocked(lambda: backend.solve(scheds))
        log(f"schedule batch compile+first: {time.time() - t0:.1f}s")
        sched_time, sched_block, sched_reps = steady_time(lambda: backend.solve(scheds))
        log(
            f"schedule batch steady: {sched_time:.3f}s/call ({sched_reps} calls, "
            f"{sched_block:.2f}s block) for {n_sched} schedules "
            f"-> {n_sched / sched_time:.1f} schedules/s"
        )
        sched_metrics = {
            "schedules_per_sec_dim27": round(n_sched / sched_time, 1),
            "schedules_dim27_steady_s": round(sched_block, 3),
            "schedules_dim27_repeats": sched_reps,
        }
        # run -> counts rate (batched measurement pipeline: one device->host
        # transfer for the whole batch)
        try:
            t0 = time.time()
            blocked(lambda: backend.run(scheds).result())
            log(f"run compile+first: {time.time() - t0:.1f}s")
            run_time, run_block, run_reps = steady_time(
                lambda: backend.run(scheds).result()
            )
            log(
                f"backend.run steady: {run_time:.2f}s/call ({run_reps} calls, "
                f"{run_block:.2f}s block) -> {n_sched / run_time:.1f} experiments/s"
            )
            sched_metrics["run_experiments_per_sec"] = round(n_sched / run_time, 1)
            sched_metrics["run_steady_s"] = round(run_block, 3)
            sched_metrics["run_repeats"] = run_reps
        except Exception as exc:
            log(f"run row failed: {exc!r}")

        # df32 serving row: the 1e-8-class serving mode —
        # fixed-step df32 Magnus engine on a sample-aligned grid. Host-facing
        # (f64 coefficient tables sampled per call), so the steady rate
        # includes that honest host cost.
        try:
            backend.set_options(
                solver_options={
                    # the 6th-order rule gains ~2^6 per halving of max_dt;
                    # 0.0125 sits well below the 1e-8 bar
                    "method": "fused_dopri5", "precision": "df32",
                    "max_dt": float(os.environ.get("BENCH_DF32_SERVE_DT", "0.0125")),
                }
            )
            t0 = time.time()
            df_serve_out = blocked(lambda: backend.solve(scheds))
            log(f"df32 serving compile+first: {time.time() - t0:.1f}s")
            dfs_time, dfs_block, dfs_reps = steady_time(
                lambda: backend.solve(scheds), max_repeats=16
            )
            log(
                f"df32 serving steady: {dfs_time:.2f}s/call ({dfs_reps} calls, "
                f"{dfs_block:.2f}s block) -> {n_sched / dfs_time:.1f} schedules/s"
            )
            # accuracy vs host DOP853(1e-12) on 2 probe schedules
            dfs_err = 0.0
            y0_serve = backend._resolve_y0(None)
            for i in (0, n_sched - 1):
                dur = scheds[i].duration * backend.dt
                df_probe = backend.solve([scheds[i]], convert_results=False)
                r = backend.options.solver.solve(
                    t_span=[0.0, dur], y0=y0_serve, signals=[scheds[i]],
                    method="DOP853", atol=1e-12, rtol=1e-12,
                    convert_results=False,
                )  # schedule-list input -> list of results
                dfs_err = max(
                    dfs_err,
                    float(np.max(np.abs(
                        np.asarray(df_probe[0].y[-1]) - np.asarray(r[0].y[-1])
                    ))),
                )
            log(f"df32 serving max |state - DOP853(1e-12)| over 2 probes: {dfs_err:.2e}")
            sched_metrics["schedules_per_sec_dim27_df32"] = round(n_sched / dfs_time, 1)
            sched_metrics["schedules_dim27_df32_max_err"] = float(f"{dfs_err:.3g}")
            sched_metrics["schedules_dim27_df32_steady_s"] = round(dfs_block, 3)
            sched_metrics["schedules_dim27_df32_repeats"] = dfs_reps
        except Exception as exc:
            log(f"df32 serving row failed: {exc!r}")
        finally:
            backend.set_options(solver_options={"method": "fused_dopri5"})

    # --- large-dim row: dim-8 vectorized Lindblad sweep (solve dim 64)
    # through the batch-major XLA engine, Magnus order-3 (6th order) at
    # dt=0.05, and the magnus-2/dt=0.02 variant ---
    lind_metrics = {}
    if os.environ.get("BENCH_LINDBLAD8", "1") == "1":
        try:
            from qiskit_dynamics_tpu.models import LindbladModel
            from qiskit_dynamics_tpu.solvers import fused_sweep_solve

            dim8 = 8
            a_op = np.diag(np.sqrt(np.arange(1, dim8)), 1)
            N_op = np.diag(np.arange(dim8, dtype=float))
            H0 = 2 * np.pi * (5.0 * N_op - 0.33 / 2 * (N_op @ N_op - N_op))
            Hd = 2 * np.pi * 0.02 * (a_op + a_op.conj().T)
            lmodel = LindbladModel(
                static_hamiltonian=H0, hamiltonian_operators=[Hd],
                static_dissipators=[np.sqrt(0.01) * a_op],
                rotating_frame=np.diag(H0), vectorized=True,
            )
            rho0 = np.zeros((dim8, dim8), dtype=complex)
            rho0[1, 1] = 1.0
            lB = 10240
            l_amps = jnp.linspace(0.2, 1.0, lB)
            l_sig = lambda amp: ([Signal(lambda t: amp, carrier_freq=5.0)], None)
            l_probe = [0, lB // 2, lB - 1]
            l_solver = Solver(
                static_hamiltonian=H0, hamiltonian_operators=[Hd],
                static_dissipators=[np.sqrt(0.01) * a_op],
                rotating_frame=np.diag(H0),
            )
            l_refs = [
                np.asarray(
                    l_solver.solve(
                        t_span=[0.0, 20.0], y0=rho0,
                        signals=[Signal(lambda t, a=float(np.asarray(l_amps)[i]): a, carrier_freq=5.0)],
                        method="DOP853", atol=1e-12, rtol=1e-12,
                    ).y[-1]
                )
                for i in l_probe
            ]

            def lind_row(magnus, dtv, key):
                l_run = jax.jit(
                    lambda a: fused_sweep_solve(
                        lmodel, l_sig, a, t_span=(0.0, 20.0), max_dt=dtv,
                        y0=rho0, magnus_order=magnus,
                    )
                )
                t0 = time.time()
                out = l_run(l_amps)
                outs = [
                    np.asarray(jnp.real(out[i])) + 1j * np.asarray(jnp.imag(out[i]))
                    for i in l_probe
                ]
                log(f"{key} compile+first: {time.time() - t0:.1f}s")
                l_time = median_time(
                    lambda: (jnp.real(l_run(l_amps))[0])
                )
                err = float(
                    max(np.max(np.abs(outs[j] - l_refs[j])) for j in range(3))
                )
                log(
                    f"{key} steady (median of 3): {l_time:.2f}s -> "
                    f"{lB / l_time:.0f} sims/s, max err {err:.2e}"
                )
                return round(lB / l_time, 1), float(f"{err:.3g}")

            tp3, err3 = lind_row(3, 0.05, "lindblad8[m3 dt=0.05]")
            lind_metrics = {
                "lindblad_dim8_sims_per_sec": tp3,
                "lindblad_dim8_max_err": err3,
            }
            # the magnus-2, dt=0.02 variant of the same row
            try:
                tp2, err2 = lind_row(2, 0.02, "lindblad8[m2 dt=0.02]")
                lind_metrics["lindblad_dim8_magnus2_sims_per_sec"] = tp2
                lind_metrics["lindblad_dim8_magnus2_max_err"] = err2
            except Exception as exc:
                log(f"lindblad8 legacy row failed: {exc!r}")
        except Exception as exc:
            log(f"lindblad8 row failed: {exc!r}")

    # --- dim-256 scaling row: dim-16 two-transmon vectorized Lindblad
    # (solve_dim 256) through the batch-major XLA engine, Magnus order-3 ---
    if os.environ.get("BENCH_LINDBLAD256", "1") == "1":
        try:
            from qiskit_dynamics_tpu.models import LindbladModel
            from qiskit_dynamics_tpu.solvers import fused_sweep_solve

            d4 = 4
            a4 = np.diag(np.sqrt(np.arange(1, d4)), 1)
            N4 = np.diag(np.arange(d4, dtype=float))
            I4 = np.eye(d4)
            H0b = (
                2 * np.pi * 5.0 * np.kron(N4, I4)
                + np.pi * (-0.33) * np.kron(N4 @ (N4 - I4), I4)
                + 2 * np.pi * 5.1 * np.kron(I4, N4)
                + np.pi * (-0.33) * np.kron(I4, N4 @ (N4 - I4))
                + 2 * np.pi * 0.002 * (np.kron(a4.conj().T, a4) + np.kron(a4, a4.conj().T))
            )
            Hdb = 2 * np.pi * 0.02 * np.kron(a4 + a4.conj().T, I4)
            l2model = LindbladModel(
                static_hamiltonian=H0b, hamiltonian_operators=[Hdb],
                static_dissipators=[
                    np.sqrt(0.005) * np.kron(a4, I4),
                    np.sqrt(0.005) * np.kron(I4, a4),
                ],
                rotating_frame=np.diag(H0b), vectorized=True,
            )
            rho2 = np.zeros((16, 16), dtype=complex)
            rho2[1, 1] = 1.0
            l2B = 2048
            l2_amps = jnp.linspace(0.2, 1.0, l2B)
            l2_sig = lambda amp: (
                [Signal(lambda t: amp, carrier_freq=5.1)], None
            )
            # primary engine: "poly" — the polynomial-expanded Magnus
            # engine collapses the per-member batched commutator matmuls
            # into one (B, Q) @ (Q, n^2) contraction
            l2_run = jax.jit(
                lambda a: fused_sweep_solve(
                    l2model, l2_sig, a, t_span=(0.0, 10.0), max_dt=0.08,
                    y0=rho2, magnus_order=3, sweep_engine="poly",
                )
            )
            t0 = time.time()
            out2 = blocked(lambda: l2_run(l2_amps))
            probes2 = [0, l2B - 1]
            outs2 = [
                np.asarray(jnp.real(out2[i])) + 1j * np.asarray(jnp.imag(out2[i]))
                for i in probes2
            ]
            log(f"lindblad256 compile+first: {time.time() - t0:.1f}s")
            l2_time, l2_block, l2_reps = steady_time(
                lambda: (jnp.real(l2_run(l2_amps))[0])
            )
            lind_metrics["lindblad_dim256_steady_s"] = round(l2_block, 3)
            lind_metrics["lindblad_dim256_repeats"] = l2_reps
            # the same row on the batch-major XLA engine
            try:
                l2x_run = jax.jit(
                    lambda a: jnp.real(fused_sweep_solve(
                        l2model, l2_sig, a, t_span=(0.0, 10.0), max_dt=0.08,
                        y0=rho2, magnus_order=3, sweep_engine="xla",
                    ))[0, 0, 0]
                )
                blocked(lambda: (l2x_run(l2_amps)))
                l2x_time = median_time(lambda: (l2x_run(l2_amps)))
                lind_metrics["lindblad_dim256_xla_sims_per_sec"] = round(
                    l2B / l2x_time, 1
                )
                log(f"lindblad256[xla continuity]: {l2B / l2x_time:.0f} sims/s")
            except Exception as exc:
                log(f"lindblad256 xla continuity row failed: {exc!r}")
            l2_solver = Solver(
                static_hamiltonian=H0b, hamiltonian_operators=[Hdb],
                static_dissipators=[
                    np.sqrt(0.005) * np.kron(a4, I4),
                    np.sqrt(0.005) * np.kron(I4, a4),
                ],
                rotating_frame=np.diag(H0b),
            )
            l2_err = 0.0
            for j, i in enumerate(probes2):
                r = l2_solver.solve(
                    t_span=[0.0, 10.0], y0=rho2,
                    signals=[Signal(lambda t, a=float(np.asarray(l2_amps)[i]): a, carrier_freq=5.1)],
                    method="DOP853", atol=1e-12, rtol=1e-12,
                )
                l2_err = max(l2_err, float(np.max(np.abs(outs2[j] - np.asarray(r.y[-1])))))
            log(
                f"lindblad256 steady (median of 3): {l2_time:.2f}s -> "
                f"{l2B / l2_time:.0f} sims/s, max err {l2_err:.2e}"
            )
            lind_metrics["lindblad_dim256_sims_per_sec"] = round(l2B / l2_time, 1)
            lind_metrics["lindblad_dim256_max_err"] = float(f"{l2_err:.3g}")
        except Exception as exc:
            log(f"lindblad256 row failed: {exc!r}")

    # --- dim-256 expm chain: lax.scan over the batched Taylor expm ---
    expm_metrics = {}
    if os.environ.get("BENCH_EXPM_CHAIN", "1") == "1":
        try:
            from qiskit_dynamics_tpu.benchmarks import expm_chain

            Tc, bc, nc = 64, 8, 256
            rng = np.random.default_rng(0)
            A = rng.normal(size=(Tc, bc, nc, nc)) + 1j * rng.normal(
                size=(Tc, bc, nc, nc)
            )
            A = -0.5j * (A + np.conj(np.swapaxes(A, -1, -2)))
            A = A / np.linalg.norm(A, axis=(-2, -1), keepdims=True) * 2.0
            eye = np.broadcast_to(np.eye(nc, dtype=complex), (bc, nc, nc))
            f32 = np.float32
            Ar, Ai = jax.device_put(A.real.astype(f32)), jax.device_put(A.imag.astype(f32))
            yr, yi = jax.device_put(eye.real.astype(f32)), jax.device_put(eye.imag.astype(f32))
            vals = {}
            # squarings=1: ||G dt|| = 1.8 here, so the scaled argument norm
            # is 0.9 and Taylor-12 truncates at 0.9^13/13! ~ 4e-14 — the
            # second squaring bought nothing but its matmul (1 of 8/step)
            for eng in ("xla",):
                f = jax.jit(
                    lambda ar, ai, br, bi: jnp.sum(
                        jnp.abs(expm_chain(ar + 1j * ai, 0.9, br + 1j * bi,
                                           squarings=1))
                    )
                )
                t0 = time.time()
                val = blocked(lambda: (f(Ar, Ai, yr, yi)))
                log(f"expm-chain[{eng}]: compile+first {time.time() - t0:.1f}s")
                med, ec_block, ec_reps = steady_time(
                    lambda: (f(Ar, Ai, yr, yi))
                )
                us = med / (Tc * bc) * 1e6
                log(
                    f"expm-chain[{eng}]: {us:.1f} us/expm+apply "
                    f"({ec_reps} calls, {ec_block:.2f}s block)"
                )
                expm_metrics[f"expm_chain_{eng}_us"] = round(us, 1)
                expm_metrics[f"expm_chain_{eng}_steady_s"] = round(ec_block, 3)
                expm_metrics[f"expm_chain_{eng}_repeats"] = ec_reps
                vals[eng] = float(val)
        except Exception as exc:
            log(f"expm-chain row failed: {exc!r}")

    # --- BASELINE config 4: Dyson (Dysolve) perturbative sweep + gradient ---
    dyson_metrics = {}
    if os.environ.get("BENCH_DYSON", "1") == "1":
        try:
            from qiskit_dynamics_tpu.benchmarks import dyson_transmon_solver
            from qiskit_dynamics_tpu.solvers import solve_ode

            ds, nu_d = dyson_transmon_solver()
            dim_d = 10
            n_steps_d, B_d = 1000, 2048
            Tt = n_steps_d * 0.1
            y0_d = np.zeros(dim_d, dtype=complex)
            y0_d[0] = 1.0
            d_amps = jnp.linspace(0.2, 1.0, B_d)
            sigma_d = Tt / 6.0

            def d_sigs(amp):
                return [
                    Signal(
                        lambda t: amp
                        * jnp.exp(-((t - Tt / 2) ** 2) / (2 * sigma_d**2)),
                        carrier_freq=nu_d,
                    )
                ]

            d_run = jax.jit(
                lambda a: jnp.abs(ds.solve_sweep(0.0, n_steps_d, y0_d, d_sigs, a)) ** 2
            )
            t0 = time.time()
            blocked(lambda: (d_run(d_amps)))
            log(f"dyson sweep compile+first: {time.time() - t0:.1f}s")
            d_time, d_block, d_reps = steady_time(lambda: (d_run(d_amps)))
            log(
                f"dyson sweep steady: {d_time:.3f}s/call ({d_reps} calls, "
                f"{d_block:.2f}s block) for {B_d} sims -> {B_d / d_time:.0f} sims/s"
            )
            dyson_metrics["dyson_sweep_sims_per_sec"] = round(B_d / d_time, 1)
            dyson_metrics["dyson_sweep_steady_s"] = round(d_block, 3)
            dyson_metrics["dyson_sweep_repeats"] = d_reps

            # accuracy: 3 probes vs host DOP853(1e-12) in the same rotating
            # frame (Dysolve solves the toggling-frame LMDE)
            from scipy.linalg import expm as scipy_expm

            G0 = np.asarray(-1j * (2 * np.pi * nu_d * np.diag(np.arange(dim_d))
                                   + np.pi * (-0.33) * np.diag(np.arange(dim_d) * (np.arange(dim_d) - 1))))
            a_d = np.diag(np.sqrt(np.arange(1, dim_d)), 1)
            G1 = -1j * 2 * np.pi * 0.02 * (a_d + a_d.conj().T)
            d_probe = np.linspace(0, B_d - 1, 3).astype(int)
            d_out = np.abs(np.asarray(d_run(d_amps))) ** 0.5  # |amplitudes|
            d_err = 0.0
            for i in d_probe:
                amp = float(np.asarray(d_amps)[i])
                env = lambda t, amp=amp: amp * np.exp(-((t - Tt / 2) ** 2) / (2 * sigma_d**2))
                rhs = lambda t, y: (G0 + np.real(env(t) * np.exp(1j * 2 * np.pi * nu_d * t)) * G1) @ y
                r = solve_ode(rhs, [0.0, Tt], y0_d, method="DOP853", atol=1e-12, rtol=1e-12)
                ref = scipy_expm(-Tt * G0) @ np.asarray(r.y[-1])
                d_err = max(d_err, float(np.max(np.abs(d_out[i] - np.abs(ref)))))
            log(f"dyson max ||amp| - DOP853(1e-12)| over 3 probes: {d_err:.2e}")
            dyson_metrics["dyson_max_err"] = float(f"{d_err:.3g}")

            # gradient through the whole perturbative sweep. The loss runs
            # the batch in SEQUENTIAL checkpointed chunks (lax.map +
            # jax.checkpoint): reverse-mode through the monomial recursion
            # materializes a (209, 6, 1000, B) f32 temp (~10 GB at
            # B=2048), and a host-level Python chunk loop doesn't help
            # because XLA schedules the chunks concurrently
            @jax.checkpoint
            def d_chunk_loss(c):
                yf = ds.solve_sweep(0.0, n_steps_d, y0_d, d_sigs, c)
                return jnp.sum(jnp.abs(yf[:, 1]) ** 2)

            def d_loss(a):
                return jnp.sum(jax.lax.map(d_chunk_loss, a.reshape(8, -1))) / B_d

            d_gradfn = jax.jit(jax.grad(d_loss))
            t0 = time.time()
            blocked(lambda: (d_gradfn(d_amps)))
            log(f"dyson grad compile+first: {time.time() - t0:.1f}s")
            dg_time = median_time(lambda: (d_gradfn(d_amps)))
            log(
                f"dyson grad steady (median of 3): {dg_time:.3f}s "
                f"-> {B_d / dg_time:.0f} grad-sims/s"
            )
            dyson_metrics["dyson_grad_sims_per_sec"] = round(B_d / dg_time, 1)
        except Exception as exc:
            log(f"dyson row failed: {exc!r}")

    # --- df32 Dysolve row: the perturbative family's 1e-8 on-chip mode ---
    # (BASELINE config 4 at the reference's accuracy bar: host-f64
    # coefficients + df32 chain, ops/df_chain.py). Envelopes are
    # numpy-written so host sampling is f64; the Gaussian amplitude sweep
    # factorizes rank-1 and the coefficient table assembles on device.
    if os.environ.get("BENCH_DYSON_DF", "1") == "1":
        try:
            from qiskit_dynamics_tpu.benchmarks import dyson_transmon_solver
            from qiskit_dynamics_tpu.solvers import solve_ode
            from scipy.linalg import expm as scipy_expm

            # chebyshev_order=2: at cheb order 1 the LINEAR envelope fit per
            # step floors the expansion near 1e-8 regardless of Dyson order;
            # dt=0.1 is also the carrier-coherence sweet spot (nu*dt = 0.5
            # -> per-step systematic errors cancel pairwise)
            ds_df, nu_df = dyson_transmon_solver(chebyshev_order=2, expansion_order=5)
            dim_df = 10
            n_steps_df, B_df = 1000, 2048
            Tt_df = n_steps_df * 0.1
            y0_df = np.zeros(dim_df, dtype=complex)
            y0_df[0] = 1.0
            df_amps_d = np.linspace(0.2, 1.0, B_df)
            sigma_df = Tt_df / 6.0

            def df_sigs(amp):
                return [
                    Signal(
                        lambda t: amp
                        * np.exp(-((t - Tt_df / 2) ** 2) / (2 * sigma_df**2)),
                        carrier_freq=nu_df,
                    )
                ]

            def df_run():
                # chunk 1024: the cheb-2 config's M=461 monomial tensor is
                # (461, 1000, B) f32 — 1.9 GB per 1024-chunk keeps transients
                # comfortably inside HBM
                return ds_df.solve_sweep(
                    0.0, n_steps_df, y0_df, df_sigs, df_amps_d,
                    precision="df32", df_chunk_b=1024,
                )

            t0 = time.time()
            ddf_out = blocked(df_run)
            log(f"dyson-df32 compile+first: {time.time() - t0:.1f}s")
            ddf_time, ddf_block, ddf_reps = steady_time(df_run)
            log(
                f"dyson-df32 steady: {ddf_time:.3f}s/call ({ddf_reps} calls, "
                f"{ddf_block:.2f}s block) -> {B_df / ddf_time:.0f} sims/s"
            )
            # accuracy: COMPLEX state agreement vs host DOP853(1e-12) in the
            # same rotating frame (stronger than the f32 row's |amplitude|
            # comparison — phase errors count)
            G0d = np.asarray(
                -1j
                * (
                    2 * np.pi * nu_df * np.diag(np.arange(dim_df))
                    + np.pi * (-0.33) * np.diag(np.arange(dim_df) * (np.arange(dim_df) - 1))
                )
            )
            a_df = np.diag(np.sqrt(np.arange(1, dim_df)), 1)
            G1d = -1j * 2 * np.pi * 0.02 * (a_df + a_df.conj().T)
            ddf_err = 0.0
            for i in np.linspace(0, B_df - 1, 3).astype(int):
                amp = float(df_amps_d[i])
                env = lambda t, amp=amp: amp * np.exp(
                    -((t - Tt_df / 2) ** 2) / (2 * sigma_df**2)
                )
                rhs = lambda t, y: (
                    G0d + np.real(env(t) * np.exp(1j * 2 * np.pi * nu_df * t)) * G1d
                ) @ y
                r = solve_ode(
                    rhs, [0.0, Tt_df], y0_df, method="DOP853", atol=1e-12, rtol=1e-12
                )
                ref = scipy_expm(-Tt_df * G0d) @ np.asarray(r.y[-1])
                ddf_err = max(ddf_err, float(np.max(np.abs(ddf_out[i] - ref))))
            log(f"dyson-df32 max |state - DOP853(1e-12)| over 3 probes: {ddf_err:.2e}")
            dyson_metrics["dyson_df_sims_per_sec"] = round(B_df / ddf_time, 1)
            dyson_metrics["dyson_df_max_err"] = float(f"{ddf_err:.3g}")
            dyson_metrics["dyson_df_steady_s"] = round(ddf_block, 3)
            dyson_metrics["dyson_df_repeats"] = ddf_reps
        except Exception as exc:
            log(f"dyson-df32 row failed: {exc!r}")

    # --- Magnus variant of config 4: per-step batched expm, with AD ---
    if os.environ.get("BENCH_MAGNUS", "1") == "1":
        try:
            from qiskit_dynamics_tpu.benchmarks import magnus_transmon_solver
            from qiskit_dynamics_tpu.solvers import solve_ode
            from scipy.linalg import expm as scipy_expm

            ms, nu_m = magnus_transmon_solver()
            dim_m = 10
            n_steps_m, B_m = 1000, 2048
            Tt_m = n_steps_m * 0.1
            y0_m = np.zeros(dim_m, dtype=complex)
            y0_m[0] = 1.0
            m_amps = jnp.linspace(0.2, 1.0, B_m)
            sigma_m = Tt_m / 6.0

            def m_sigs(amp):
                return [
                    Signal(
                        lambda t: amp
                        * jnp.exp(-((t - Tt_m / 2) ** 2) / (2 * sigma_m**2)),
                        carrier_freq=nu_m,
                    )
                ]

            m_run = jax.jit(
                lambda a: jnp.abs(ms.solve_sweep(0.0, n_steps_m, y0_m, m_sigs, a)) ** 2
            )
            t0 = time.time()
            blocked(lambda: (m_run(m_amps)))
            log(f"magnus sweep compile+first: {time.time() - t0:.1f}s")
            m_time, m_block, m_reps = steady_time(lambda: (m_run(m_amps)))
            log(
                f"magnus sweep steady: {m_time:.3f}s/call ({m_reps} calls, "
                f"{m_block:.2f}s block) for {B_m} sims -> {B_m / m_time:.0f} sims/s"
            )
            dyson_metrics["magnus_sweep_sims_per_sec"] = round(B_m / m_time, 1)
            dyson_metrics["magnus_sweep_steady_s"] = round(m_block, 3)
            dyson_metrics["magnus_sweep_repeats"] = m_reps

            G0m = np.asarray(
                -1j
                * (
                    2 * np.pi * nu_m * np.diag(np.arange(dim_m))
                    + np.pi * (-0.33) * np.diag(np.arange(dim_m) * (np.arange(dim_m) - 1))
                )
            )
            a_m = np.diag(np.sqrt(np.arange(1, dim_m)), 1)
            G1m = -1j * 2 * np.pi * 0.02 * (a_m + a_m.conj().T)
            m_probe = np.linspace(0, B_m - 1, 3).astype(int)
            m_out = np.abs(np.asarray(m_run(m_amps))) ** 0.5
            m_err = 0.0
            for i in m_probe:
                amp = float(np.asarray(m_amps)[i])
                env = lambda t, amp=amp: amp * np.exp(
                    -((t - Tt_m / 2) ** 2) / (2 * sigma_m**2)
                )
                rhs = lambda t, y: (
                    G0m
                    + np.real(env(t) * np.exp(1j * 2 * np.pi * nu_m * t)) * G1m
                ) @ y
                r = solve_ode(
                    rhs, [0.0, Tt_m], y0_m, method="DOP853", atol=1e-12, rtol=1e-12
                )
                ref = scipy_expm(-Tt_m * G0m) @ np.asarray(r.y[-1])
                m_err = max(m_err, float(np.max(np.abs(m_out[i] - np.abs(ref)))))
            log(f"magnus max ||amp| - DOP853(1e-12)| over 3 probes: {m_err:.2e}")
            dyson_metrics["magnus_max_err"] = float(f"{m_err:.3g}")

            # gradient: same checkpointed-chunk pattern as the Dyson row
            @jax.checkpoint
            def m_chunk_loss(c):
                yf = ms.solve_sweep(0.0, n_steps_m, y0_m, m_sigs, c)
                return jnp.sum(jnp.abs(yf[:, 1]) ** 2)

            def m_loss(a):
                return jnp.sum(jax.lax.map(m_chunk_loss, a.reshape(8, -1))) / B_m

            m_gradfn = jax.jit(jax.grad(m_loss))
            t0 = time.time()
            blocked(lambda: (m_gradfn(m_amps)))
            log(f"magnus grad compile+first: {time.time() - t0:.1f}s")
            mg_time = median_time(lambda: (m_gradfn(m_amps)))
            log(
                f"magnus grad steady (median of 3): {mg_time:.3f}s "
                f"-> {B_m / mg_time:.0f} grad-sims/s"
            )
            dyson_metrics["magnus_grad_sims_per_sec"] = round(B_m / mg_time, 1)
        except Exception as exc:
            log(f"magnus row failed: {exc!r}")

    # --- Monte Carlo trajectory unraveling (beyond-reference) ---
    if os.environ.get("BENCH_MC", "1") == "1":
        try:
            from qiskit_dynamics_tpu.models import LindbladModel
            from qiskit_dynamics_tpu.solvers import (
                solve_mc_trajectories,
                mc_expectation,
            )

            Zq = np.diag([1.0, -1.0]).astype(complex)
            SMq = np.array([[0.0, 1.0], [0.0, 0.0]], dtype=complex)
            gamma_mc = 0.5
            mc_model = LindbladModel(
                static_hamiltonian=0.0 * Zq,
                static_dissipators=[np.sqrt(gamma_mc) * SMq],
            )
            N_OP = np.diag([0.0, 1.0]).astype(complex)
            mc_traj, mc_steps = 8192, 800

            def mc_run(key):
                res = solve_mc_trajectories(
                    mc_model, (0.0, 2.0), np.array([0.0, 1.0], dtype=complex),
                    n_traj=mc_traj, key=key, n_steps=mc_steps, n_save=8,
                )
                return mc_expectation(res.states, N_OP)

            mc_f = jax.jit(mc_run)
            t0 = time.time()
            blocked(lambda: (mc_f(jax.random.PRNGKey(7))))
            log(f"mc compile+first: {time.time() - t0:.1f}s")
            mc_time, mc_block, mc_reps = steady_time(
                lambda: (mc_f(jax.random.PRNGKey(8)))
            )
            mc_p = np.asarray(mc_f(jax.random.PRNGKey(8)))
            mc_expected = np.exp(-gamma_mc * np.linspace(0, 2, 9))
            mc_err = float(np.max(np.abs(mc_p - mc_expected)))
            # z-score gate: per save point the estimator
            # std is sqrt(p(1-p)/N); a real statistics bug shows as a large
            # max-z, which the plain max-err number can hide
            mc_sigma = np.sqrt(
                np.maximum(mc_expected * (1 - mc_expected), 1e-12) / mc_traj
            )
            mc_z = float(np.max(np.abs(mc_p - mc_expected) / mc_sigma))
            log(
                f"mc steady: {mc_time:.3f}s/call ({mc_reps} calls, {mc_block:.2f}s "
                f"block) for {mc_traj} trajectories x {mc_steps} steps -> "
                f"{mc_traj / mc_time:.0f} traj/s; stat err {mc_err:.3f} "
                f"(max z {mc_z:.2f})"
            )
            dyson_metrics["mc_traj_per_sec"] = round(mc_traj / mc_time, 1)
            dyson_metrics["mc_stat_err"] = float(f"{mc_err:.3g}")
            dyson_metrics["mc_stat_zmax"] = round(mc_z, 2)
            dyson_metrics["mc_steady_s"] = round(mc_block, 3)
            dyson_metrics["mc_repeats"] = mc_reps
            if mc_z > 4.0:
                log("mc STATISTICS GATE FAILED: max z > 4")
                dyson_metrics["mc_stat_gate"] = "FAIL"

            # sweep variant: 64-member decay-rate sweep x 256 trajectories
            from qiskit_dynamics_tpu.solvers import solve_mc_trajectories_sweep

            g_sweep = jnp.linspace(0.2, 0.9, 64)
            mc_model2 = LindbladModel(
                static_hamiltonian=0.0 * Zq, dissipator_operators=[SMq]
            )

            def mcs_run(key):
                res = solve_mc_trajectories_sweep(
                    mc_model2, (0.0, 2.0), np.array([0.0, 1.0], dtype=complex),
                    signals_fn=lambda g: (None, [Signal(g)]),
                    params=g_sweep, n_traj=256, key=key,
                    n_steps=400, n_save=4,
                )
                return mc_expectation(res.states, N_OP)

            mcs_f = jax.jit(mcs_run)
            t0 = time.time()
            blocked(lambda: (mcs_f(jax.random.PRNGKey(3))))
            log(f"mc-sweep compile+first: {time.time() - t0:.1f}s")
            mcs_time, mcs_block, mcs_reps = steady_time(
                lambda: (mcs_f(jax.random.PRNGKey(4)))
            )
            mcs_p = np.asarray(mcs_f(jax.random.PRNGKey(4)))
            mcs_expected = np.exp(
                -np.outer(np.linspace(0, 2, 5), np.asarray(g_sweep))
            )
            mcs_err = float(np.max(np.abs(mcs_p - mcs_expected)))
            mcs_sigma = np.sqrt(
                np.maximum(mcs_expected * (1 - mcs_expected), 1e-12) / 256
            )
            mcs_z = float(np.max(np.abs(mcs_p - mcs_expected) / mcs_sigma))
            total_mt = 64 * 256
            log(
                f"mc-sweep steady: {mcs_time:.3f}s/call ({mcs_reps} calls, "
                f"{mcs_block:.2f}s block) for {total_mt} member-trajectories -> "
                f"{total_mt / mcs_time:.0f} traj/s; stat err {mcs_err:.3f} "
                f"(max z {mcs_z:.2f})"
            )
            dyson_metrics["mc_sweep_traj_per_sec"] = round(total_mt / mcs_time, 1)
            dyson_metrics["mc_sweep_stat_err"] = float(f"{mcs_err:.3g}")
            dyson_metrics["mc_sweep_stat_zmax"] = round(mcs_z, 2)
            dyson_metrics["mc_sweep_steady_s"] = round(mcs_block, 3)
            dyson_metrics["mc_sweep_repeats"] = mcs_reps
            if mcs_z > 4.0:
                log("mc-sweep STATISTICS GATE FAILED: max z > 4")
                dyson_metrics["mc_sweep_stat_gate"] = "FAIL"
        except Exception as exc:
            log(f"mc row failed: {exc!r}")

    print(
        json.dumps(
            {
                "metric": "cr_sweep_throughput_dim16",
                "value": round(device_throughput, 2),
                "unit": "sims/sec",
                "vs_baseline": round(device_throughput / numpy_throughput, 2),
                "device": device,
                **headline_extra,
                **df_metrics,
                **cheb_metrics,
                **grad_metrics,
                **sched_metrics,
                **lind_metrics,
                **expm_metrics,
                **dyson_metrics,
            }
        )
    )


if __name__ == "__main__":
    main()
