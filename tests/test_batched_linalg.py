"""Tests for the sweep engines: batched Taylor expm, the fixed-step XLA
engine, and the lockstep-adaptive Triton kernel (interpret mode on CPU)
against its XLA twin."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy.linalg import expm as scipy_expm

from qiskit_dynamics_tpu.ops.expm import expm_taylor


def _random_batch(rng, B, n, scale=1.0):
    return scale * (
        rng.standard_normal((B, n, n)) + 1j * rng.standard_normal((B, n, n))
    )


def _magnus2_reference(H0, ops, omega, coef, y0, dt, t0, T, order=10):
    """float64 numpy Magnus-2 + Horner-Taylor sweep (the engines' polynomial)."""
    from qiskit_dynamics_tpu.ops.xla_sweep import _GAUSS_C1, _GAUSS_C2, _P2

    y = y0.astype(complex)
    for s in range(T):
        Gs = []
        for gi, c in enumerate((_GAUSS_C1, _GAUSS_C2)):
            tau = t0 + (s + c) * dt
            A = H0 + np.einsum("kb,kij->bij", coef[s, gi], ops)
            Gs.append(A * np.exp(1j * omega * tau)[None])
        G1, G2 = Gs
        M = 0.5 * dt * (G1 + G2) + _P2 * dt * dt * (G2 @ G1 - G1 @ G2)
        v = y.copy()
        for kk in range(order, 0, -1):
            v = y + np.einsum("bij,jb->ib", M, v) / kk
        y = v
    return y


class TestExpmTaylorBatched:
    """Batch-major Taylor expm (the per-step propagators of the Magnus and
    Monte-Carlo sweeps): XLA hands the batched products to its GEMM
    library."""

    @pytest.mark.parametrize("n", [1, 2, 5, 8, 16])
    @pytest.mark.parametrize("squarings", [0, 1, 2])
    def test_matches_scipy(self, n, squarings):
        rng = np.random.default_rng(10 * n + squarings)
        # spectral norm ~0.4 at every n: Taylor-12 truncation ~1e-15
        X = _random_batch(rng, 6, n, scale=0.3 / np.sqrt(n))
        P = np.asarray(expm_taylor(jnp.asarray(X), order=12, squarings=squarings))
        expected = np.stack([scipy_expm(x) for x in X])
        np.testing.assert_allclose(P, expected, atol=1e-12, rtol=1e-12)

    def test_identity_at_zero(self):
        P = np.asarray(expm_taylor(jnp.zeros((3, 4, 4), jnp.complex128), order=6))
        np.testing.assert_allclose(P, np.broadcast_to(np.eye(4), (3, 4, 4)), atol=1e-15)

    def test_grad_matches_fd(self):
        """Plain autodiff through the batched polynomial (the Magnus sweep's
        gradient path) against central finite differences."""
        rng = np.random.default_rng(4)
        X0 = jnp.asarray(_random_batch(rng, 4, 3, scale=0.2))
        D = jnp.asarray(rng.normal(size=(4, 3, 3)))

        def loss(a):
            P = expm_taylor(X0 * a, order=8, squarings=1)
            return jnp.sum(jnp.real(P) * D) + jnp.sum(jnp.imag(P) * D**2)

        g = float(jax.grad(loss)(0.7))
        eps = 1e-6
        fd = (float(loss(0.7 + eps)) - float(loss(0.7 - eps))) / (2 * eps)
        np.testing.assert_allclose(g, fd, rtol=1e-6)


class TestFusedSweepSolver:
    def test_fused_matches_generic_path(self):
        import jax
        from qiskit_dynamics_tpu.benchmarks import cr_solver, fused_cr_sweep
        from qiskit_dynamics_tpu import Signal

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        amps = jnp.array([0.3, 0.75, 1.0])
        T, dt = 2.0, 0.5
        out = fused_cr_sweep(solver, w1, amps, t_final=T, dt=dt)

        def ref(amp):
            sig = Signal(lambda t: amp * 0.02, carrier_freq=w1)
            res = solver.solve(
                t_span=[0.0, T], y0=y0, signals=[sig], method="jax_expm",
                max_dt=dt, magnus_order=2, expm_method="taylor",
                expm_order=8, expm_squarings=0,
            )
            return jnp.abs(res.y[-1]) ** 2

        expected = jax.vmap(ref)(amps)
        np.testing.assert_allclose(np.asarray(out), np.asarray(expected), atol=1e-10)

    def test_hermitian_kernel_path_matches_general(self):
        # anti-Hermitian generators: the one-matmul commutator path
        # (hermitian=True) must agree with the two-matmul general path
        from qiskit_dynamics_tpu.ops.xla_sweep import sweep_expm_magnus2_xla

        rng = np.random.default_rng(1)
        n, k, T, B = 6, 2, 15, 8
        dt, t0 = 0.05, 0.2
        ah = lambda a: (a - a.conj().T) / 2
        H0 = ah(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
        ops = np.array(
            [ah(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))) for _ in range(k)]
        )
        w = rng.normal(size=n)
        omega = w[None, :] - w[:, None]
        coef = rng.normal(size=(T, 2, k, B))
        y0 = rng.normal(size=(n, B)) + 1j * rng.normal(size=(n, B))
        kw = dict(dt=dt, t0=t0, order=10)
        a = sweep_expm_magnus2_xla(H0, ops, omega, coef, y0, hermitian=False, **kw)
        b = sweep_expm_magnus2_xla(H0, ops, omega, coef, y0, hermitian=True, **kw)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)

    def test_xla_engine_matches_numpy_magnus2(self):
        # batch-major XLA engine: the float64 numpy polynomial, step for step
        from qiskit_dynamics_tpu.ops.xla_sweep import sweep_expm_magnus2_xla

        rng = np.random.default_rng(5)
        n, k, T, B = 6, 2, 12, 8
        H0 = 0.3 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
        ops = 0.3 * (rng.normal(size=(k, n, n)) + 1j * rng.normal(size=(k, n, n)))
        w = rng.normal(size=n)
        omega = w[None, :] - w[:, None]
        coef = rng.normal(size=(T, 2, k, B))
        y0 = rng.normal(size=(n, B)) + 1j * rng.normal(size=(n, B))
        a = _magnus2_reference(H0, ops, omega, coef, y0, 0.04, 0.1, T)
        b = sweep_expm_magnus2_xla(H0, ops, omega, coef, y0, dt=0.04, t0=0.1, order=10)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-13)

    def test_xla_engine_large_dim_lindblad(self):
        # dim-8 open system -> solve_dim 64 on the xla engine; cross-check
        # against the generic adaptive solver
        import jax
        from qiskit_dynamics_tpu.models import LindbladModel
        from qiskit_dynamics_tpu import Signal, Solver
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        dim = 8
        a_op = np.diag(np.sqrt(np.arange(1, dim)), 1)
        N = np.diag(np.arange(dim, dtype=float))
        H0 = 2 * np.pi * (5.0 * N - 0.33 / 2 * (N @ N - N))
        Hd = 2 * np.pi * 0.02 * (a_op + a_op.conj().T)
        model = LindbladModel(
            static_hamiltonian=H0,
            hamiltonian_operators=[Hd],
            static_dissipators=[np.sqrt(0.01) * a_op],
            rotating_frame=np.diag(H0),
            vectorized=True,
        )
        rho0 = np.zeros((dim, dim), dtype=complex)
        rho0[1, 1] = 1.0
        amps = jnp.array([0.4, 1.0])
        T = 1.0

        def signals_fn(amp):
            return ([Signal(lambda t: amp, carrier_freq=5.0)], None)

        out = fused_sweep_solve(
            model, signals_fn, amps, t_span=(0.0, T), max_dt=0.005, y0=rho0,
        )
        assert out.shape == (2, dim, dim)
        solver = Solver(
            static_hamiltonian=H0,
            hamiltonian_operators=[Hd],
            static_dissipators=[np.sqrt(0.01) * a_op],
            rotating_frame=np.diag(H0),
        )
        for i, amp in enumerate([0.4, 1.0]):
            res = solver.solve(
                t_span=[0.0, T], y0=rho0,
                signals=[Signal(lambda t, amp=amp: amp, carrier_freq=5.0)],
                method="tpu_dopri5", atol=1e-10, rtol=1e-10,
            )
            np.testing.assert_allclose(
                np.asarray(out[i]), np.asarray(res.y[-1]), atol=5e-7
            )

    def test_fused_sweep_gradient_matches_finite_differences(self):
        # plain reverse-mode AD through the XLA engine's checkpointed scan
        import jax
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve
        from qiskit_dynamics_tpu import Signal

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        T = 2.0

        def signals_fn(amp):
            return [Signal(lambda t: amp * 0.02, carrier_freq=w1)]

        def loss(amps):
            yf = fused_sweep_solve(
                solver.model, signals_fn, amps, t_span=(0.0, T), max_dt=0.5,
                y0=y0, rwa_signal_map=solver._rwa_signal_map,
            )
            return jnp.mean(jnp.abs(yf[:, 1]) ** 2)

        amps = jnp.array([0.3, 0.75, 1.0, 0.5, 0.2, 0.9, 0.6, 0.1])
        g = np.asarray(jax.grad(loss)(amps))
        eps = 1e-6
        for i in (0, 3, 7):
            ap = np.asarray(amps).copy()
            am = ap.copy()
            ap[i] += eps
            am[i] -= eps
            fd = (float(loss(jnp.asarray(ap))) - float(loss(jnp.asarray(am)))) / (2 * eps)
            np.testing.assert_allclose(g[i], fd, atol=1e-9)

    def test_t_eval_trajectories_match_generic_solver(self):
        import jax
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.exceptions import DynamicsError
        import pytest

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        T, dtmax = 2.0, 0.5
        amps = jnp.array([0.3, 0.75, 1.0, 0.5])

        def signals_fn(amp):
            return [Signal(lambda t: amp * 0.02, carrier_freq=w1)]

        t_eval = [0.0, 0.5, 1.0, 2.0]
        kw = dict(
            t_span=(0.0, T), max_dt=dtmax, y0=y0,
            rwa_signal_map=solver._rwa_signal_map, t_eval=t_eval,
        )
        traj = fused_sweep_solve(solver.model, signals_fn, amps, **kw)
        traj_x = fused_sweep_solve(
            solver.model, signals_fn, amps, sweep_engine="xla", **kw
        )
        assert traj.shape == (4, 4, 4)
        np.testing.assert_allclose(np.asarray(traj), np.asarray(traj_x), atol=1e-12)

        def ref(amp):
            sig = Signal(lambda t, a=amp: a * 0.02, carrier_freq=w1)
            res = solver.solve(
                t_span=[0.0, T], y0=y0, signals=[sig], method="jax_expm",
                max_dt=dtmax, magnus_order=2, expm_method="taylor",
                expm_order=8, expm_squarings=0, t_eval=t_eval,
            )
            return np.asarray(res.y)

        for b, a in enumerate(np.asarray(amps)):
            np.testing.assert_allclose(
                np.asarray(traj[b]), ref(float(a)), atol=1e-10
            )

        # off-grid and decreasing t_eval rejected
        with pytest.raises(DynamicsError, match="grid"):
            fused_sweep_solve(
                solver.model, signals_fn, amps,
                t_span=(0.0, T), max_dt=dtmax, y0=y0,
                rwa_signal_map=solver._rwa_signal_map, t_eval=[0.3],
            )
        with pytest.raises(DynamicsError, match="increasing"):
            fused_sweep_solve(
                solver.model, signals_fn, amps,
                t_span=(0.0, T), max_dt=dtmax, y0=y0,
                rwa_signal_map=solver._rwa_signal_map, t_eval=[1.0, 0.5],
            )

    def test_unitary_sweep_engines_agree_and_dup_teval_rejected(self):
        # batch-major (B, n, m) matrix y0 (shared generator per member) on
        # both engines, and duplicate-step t_eval rejection
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.exceptions import DynamicsError
        import pytest

        solver, w1 = cr_solver(dim=2)
        y0 = np.eye(4, dtype=complex)  # m = 4 columns per member
        amps = jnp.array([0.3, 0.75, 1.0])

        def signals_fn(amp):
            return [Signal(lambda t: amp * 0.02, carrier_freq=w1)]

        kw = dict(
            t_span=(0.0, 2.0), max_dt=0.5, y0=y0,
            rwa_signal_map=solver._rwa_signal_map,
        )
        a = fused_sweep_solve(
            solver.model, signals_fn, amps, sweep_engine="poly", **kw
        )
        b = fused_sweep_solve(
            solver.model, signals_fn, amps, sweep_engine="xla", **kw
        )
        assert a.shape == (3, 4, 4)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-13)
        t_eval = [0.5, 1.0, 2.0]
        at = fused_sweep_solve(
            solver.model, signals_fn, amps, sweep_engine="poly",
            t_eval=t_eval, **kw,
        )
        bt = fused_sweep_solve(
            solver.model, signals_fn, amps, sweep_engine="xla", t_eval=t_eval, **kw
        )
        assert at.shape == (3, 3, 4, 4)
        np.testing.assert_allclose(np.asarray(at), np.asarray(bt), atol=1e-13)
        with pytest.raises(DynamicsError, match="same fixed step"):
            fused_sweep_solve(
                solver.model, signals_fn, amps,
                t_eval=[0.5 - 1e-8, 0.5 + 1e-8], **kw,
            )

    def test_lindblad_t_eval_trajectory(self):
        # vectorized-Lindblad branch of the trajectory collector
        from qiskit_dynamics_tpu.models import LindbladModel
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve
        from qiskit_dynamics_tpu import Signal, Solver

        X = np.array([[0, 1], [1, 0]], dtype=complex)
        Z = np.array([[1, 0], [0, -1]], dtype=complex)
        sm = np.array([[0, 1], [0, 0]], dtype=complex)
        H0 = 2 * np.pi * 5.0 * Z / 2
        Hd = 2 * np.pi * 0.1 * X / 2
        model = LindbladModel(
            static_hamiltonian=H0,
            hamiltonian_operators=[Hd],
            static_dissipators=[np.sqrt(0.02) * sm],
            rotating_frame=np.diag(H0),
            vectorized=True,
        )
        rho0 = np.array([[1.0, 0], [0, 0]], dtype=complex)
        amps = jnp.array([0.4, 1.0])
        T, dtmax = 1.0, 0.01
        t_eval = [0.5, 1.0]

        def signals_fn(amp):
            return ([Signal(lambda t: amp, carrier_freq=5.0)], None)

        traj = fused_sweep_solve(
            model, signals_fn, amps, t_span=(0.0, T), max_dt=dtmax, y0=rho0,
            t_eval=t_eval,
        )
        assert traj.shape == (2, 2, 2, 2)
        solver = Solver(
            static_hamiltonian=H0,
            hamiltonian_operators=[Hd],
            static_dissipators=[np.sqrt(0.02) * sm],
            rotating_frame=np.diag(H0),
        )
        for i, amp in enumerate([0.4, 1.0]):
            res = solver.solve(
                t_span=[0.0, T], y0=rho0,
                signals=[Signal(lambda t, amp=amp: amp, carrier_freq=5.0)],
                method="tpu_dopri5", atol=1e-12, rtol=1e-12, t_eval=t_eval,
            )
            for j in range(len(t_eval)):
                np.testing.assert_allclose(
                    np.asarray(traj[i, j]), np.asarray(res.y[j]), atol=5e-7
                )

    def test_anti_hermitian_detection(self):
        from qiskit_dynamics_tpu.solvers.fused_sweep import _all_anti_hermitian

        X = np.array([[0, 1], [1, 0]], dtype=complex)
        assert _all_anti_hermitian(-1j * X, np.array([-1j * X]))
        assert not _all_anti_hermitian(X, np.array([-1j * X]))
        assert not _all_anti_hermitian(-1j * X, np.array([X]))
        # zero static op (common: all dynamics in the frame) counts
        assert _all_anti_hermitian(np.zeros((2, 2)), np.array([-1j * X]))

    def test_fused_sweep_validations(self):
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.exceptions import DynamicsError
        import pytest

        solver, w1 = cr_solver()
        model = solver.model
        y0 = np.zeros(16, dtype=complex)
        y0[0] = 1.0
        ok_fn = lambda amp: [Signal(lambda t: amp, carrier_freq=w1)]

        with pytest.raises(DynamicsError, match="t_span\\[1\\]"):
            fused_sweep_solve(model, ok_fn, jnp.array([0.1]), t_span=(0.0, -1.0),
                              max_dt=0.5, y0=y0)
        # signal count mismatch vs the RWA'd model's operator count
        with pytest.raises(DynamicsError, match="signals"):
            fused_sweep_solve(
                model, ok_fn, jnp.array([0.1]), t_span=(0.0, 1.0),
                max_dt=0.5, y0=y0,
            )


class TestLockstepAdaptiveSweep:
    def _setup(self):
        from qiskit_dynamics_tpu import Solver

        nu, r = 5.0, 0.1
        Xm = np.array([[0, 1], [1, 0]], dtype=complex)
        Zm = np.diag([1, -1]).astype(complex)
        solver = Solver(
            static_hamiltonian=2 * np.pi * nu * Zm / 2,
            hamiltonian_operators=[2 * np.pi * r * Xm / 2],
            rotating_frame=2 * np.pi * nu * Zm / 2,
        )
        model = solver.model
        coll = model._operator_collection
        d = np.asarray(model.rotating_frame.frame_diag)
        return solver, nu, (
            np.asarray(coll.static_operator),
            np.asarray(coll.operators),
            np.imag(d)[None, :] - np.imag(d)[:, None],
        )

    def test_matches_generic_adaptive(self):
        import jax
        from qiskit_dynamics_tpu.ops.adaptive_sweep import sweep_dopri5_lockstep
        from qiskit_dynamics_tpu import Signal

        solver, nu, (static_fb, ops_fb, omega) = self._setup()
        B, T = 16, 10.0
        amps = np.linspace(0.2, 1.0, B)
        y0 = np.zeros((2, B), dtype=complex)
        y0[0] = 1.0
        out = sweep_dopri5_lockstep(
            jnp.asarray(static_fb), jnp.asarray(ops_fb), jnp.asarray(omega),
            jnp.asarray([2 * np.pi * nu]), jnp.asarray(amps[None, :], dtype=complex),
            jnp.asarray(y0), tf=T, atol=1e-8, rtol=1e-8, h0=0.01,
            tile_b=16, interpret=True,
        )
        pop1 = np.abs(np.asarray(out))[1] ** 2

        def ref(amp):
            sig = Signal(lambda t: amp, carrier_freq=nu)
            res = solver.solve(t_span=[0.0, T], y0=y0[:, 0], signals=[sig],
                               method="tpu_dopri5", atol=1e-10, rtol=1e-10)
            return jnp.abs(res.y[-1][1]) ** 2

        expected = np.asarray(jax.vmap(ref)(jnp.asarray(amps)))
        np.testing.assert_allclose(pop1, expected, atol=2e-5)

    def test_bucket_lanes_permutation_roundtrip(self):
        """Stiffness bucketing must be a pure permutation: identical results
        (up to step-control differences) and correct member order."""
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve
        from qiskit_dynamics_tpu import Signal

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        # deliberately shuffled heterogeneous amplitudes
        amps = jnp.array([1.0, 0.05, 0.6, 0.2, 0.9, 0.1, 0.4, 0.75])
        sig_fn = lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)]
        kwargs = dict(
            t_span=(0.0, 2.0), y0=y0, tile_b=16, interpret=True,
            rwa_signal_map=solver._rwa_signal_map,
        )
        out_b = fused_adaptive_sweep_solve(solver.model, sig_fn, amps, **kwargs)
        out_nb = fused_adaptive_sweep_solve(
            solver.model, sig_fn, amps, bucket_lanes=False, **kwargs
        )
        # member identity preserved: both match DOP853 per member
        for i, a in enumerate(np.asarray(amps)):
            ref = solver.solve(
                t_span=[0.0, 2.0], y0=y0, signals=sig_fn(float(a)),
                method="DOP853", atol=1e-12, rtol=1e-12,
            )
            np.testing.assert_allclose(
                np.asarray(out_b[i]), np.asarray(ref.y[-1]), atol=2e-5
            )
            np.testing.assert_allclose(
                np.asarray(out_nb[i]), np.asarray(ref.y[-1]), atol=2e-5
            )

    def test_budget_exhaustion_poisons(self):
        from qiskit_dynamics_tpu.ops.adaptive_sweep import sweep_dopri5_lockstep

        _, nu, (static_fb, ops_fb, omega) = self._setup()
        y0 = np.zeros((2, 16), dtype=complex)
        y0[0] = 1.0
        out = sweep_dopri5_lockstep(
            jnp.asarray(static_fb), jnp.asarray(ops_fb), jnp.asarray(omega),
            jnp.asarray([2 * np.pi * nu]),
            jnp.ones((1, 16), dtype=complex),
            jnp.asarray(y0), tf=10.0, atol=1e-8, rtol=1e-8, h0=0.01,
            max_steps=3, tile_b=16, interpret=True,
        )
        assert np.isnan(np.asarray(out)).all()


class TestFusedAdaptiveSweepSolve:
    def test_matches_dop853(self):
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve
        from qiskit_dynamics_tpu import Signal

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        amps = jnp.array([0.3, 1.0])
        T = 2.0
        out = fused_adaptive_sweep_solve(
            solver.model,
            lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)],
            amps, t_span=(0.0, T), y0=y0, atol=1e-9, rtol=1e-9, h0=0.01,
            tile_b=16, interpret=True, rwa_signal_map=solver._rwa_signal_map,
        )
        pops = np.abs(np.asarray(out)) ** 2
        for i, a in enumerate([0.3, 1.0]):
            ref = solver.solve(
                t_span=[0.0, T], y0=y0,
                signals=[Signal(lambda t, a=a: a * 0.02, carrier_freq=w1)],
                method="DOP853", atol=1e-12, rtol=1e-12,
            )
            np.testing.assert_allclose(
                pops[i], np.abs(np.asarray(ref.y[-1])) ** 2, atol=1e-5
            )

    def test_unitary_sweep_2d_y0(self):
        """y0 = identity -> per-member unitaries via column-to-lane mapping."""
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve
        from qiskit_dynamics_tpu import Signal

        solver, w1 = cr_solver(dim=2)
        dim = solver.model.dim
        amps = jnp.array([0.3, 0.9])
        T = 2.0
        fn = lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)]
        U = fused_sweep_solve(
            solver.model, fn, amps, t_span=(0.0, T), max_dt=0.5,
            y0=np.eye(dim, dtype=complex),
            rwa_signal_map=solver._rwa_signal_map,
        )
        assert U.shape == (2, dim, dim)
        for i, a in enumerate([0.3, 0.9]):
            sig = Signal(lambda t, a=a: a * 0.02, carrier_freq=w1)
            ref = solver.solve(
                t_span=[0.0, T], y0=np.eye(dim, dtype=complex), signals=[sig],
                method="jax_expm", max_dt=0.5, magnus_order=2,
                expm_method="taylor", expm_order=8, expm_squarings=0,
            )
            np.testing.assert_allclose(
                np.asarray(U[i]), np.asarray(ref.y[-1]), atol=1e-9
            )

    def test_envelope_table_pulse_sweep(self):
        """Piecewise-constant envelope tables: Gaussian-pulse amplitude sweep
        matches DOP853 on the identical DiscreteSignal."""
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve
        from qiskit_dynamics_tpu import Signal, DiscreteSignal

        solver, w1 = cr_solver(dim=2)
        model = solver.model
        dim = model.dim
        y0 = np.zeros(dim, dtype=complex)
        y0[0] = 1.0
        T, S = 4.0, 80
        env_dt = T / S
        amps = jnp.array([0.5, 1.0])

        def signals_fn(a):
            return [Signal(
                lambda t: a * 0.1 * jnp.exp(-((t - T / 2) ** 2) / (2 * 0.8**2)),
                carrier_freq=w1,
            )]

        out = fused_adaptive_sweep_solve(
            model, signals_fn, amps, t_span=(0.0, T), y0=y0, atol=1e-9, rtol=1e-9,
            h0=0.005, tile_b=16, interpret=True,
            rwa_signal_map=solver._rwa_signal_map, envelope_resolution=S,
        )
        pops = np.abs(np.asarray(out)) ** 2
        ts = (np.arange(S) + 0.5) * env_dt
        for i, a in enumerate([0.5, 1.0]):
            samples = a * 0.1 * np.exp(-((ts - T / 2) ** 2) / (2 * 0.8**2))
            dsig = DiscreteSignal(dt=env_dt, samples=samples.astype(complex),
                                  carrier_freq=w1)
            ref = solver.solve(t_span=[0.0, T], y0=y0, signals=[dsig],
                               method="DOP853", atol=1e-12, rtol=1e-12)
            np.testing.assert_allclose(
                pops[i], np.abs(np.asarray(ref.y[-1])) ** 2, atol=1e-5
            )

    def test_envelope_table_with_t_eval(self):
        """Both step-clipping mechanisms combined: envelope-cell boundaries
        AND arbitrary trajectory times — trajectory matches DOP853 on the
        identical DiscreteSignal at every t_eval point."""
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve
        from qiskit_dynamics_tpu import Signal, DiscreteSignal

        solver, w1 = cr_solver(dim=2)
        model = solver.model
        dim = model.dim
        y0 = np.zeros(dim, dtype=complex)
        y0[0] = 1.0
        T, S = 4.0, 80
        env_dt = T / S
        amps = jnp.array([0.5, 1.0])
        t_eval = [1.3, 2.7, 4.0]  # off both grids except tf

        def signals_fn(a):
            return [Signal(
                lambda t: a * 0.1 * jnp.exp(-((t - T / 2) ** 2) / (2 * 0.8**2)),
                carrier_freq=w1,
            )]

        traj = fused_adaptive_sweep_solve(
            model, signals_fn, amps, t_span=(0.0, T), y0=y0, atol=1e-9,
            rtol=1e-9, h0=0.005, tile_b=16, interpret=True,
            rwa_signal_map=solver._rwa_signal_map, envelope_resolution=S,
            t_eval=t_eval,
        )
        assert traj.shape == (2, 3, dim)
        ts = (np.arange(S) + 0.5) * env_dt
        for i, a in enumerate([0.5, 1.0]):
            samples = a * 0.1 * np.exp(-((ts - T / 2) ** 2) / (2 * 0.8**2))
            dsig = DiscreteSignal(
                dt=env_dt, samples=samples.astype(complex), carrier_freq=w1
            )
            ref = solver.solve(
                t_span=[0.0, T], y0=y0, signals=[dsig], method="DOP853",
                atol=1e-12, rtol=1e-12, t_eval=t_eval,
            )
            np.testing.assert_allclose(
                np.abs(np.asarray(traj[i])) ** 2,
                np.abs(np.asarray(ref.y)) ** 2,
                atol=2e-5,
            )

    def test_lindblad_vectorized_fused_sweep(self):
        """Vectorized Lindblad sweeps through the fused solve match the
        generic vectorized DOP853 solve."""
        from qiskit_dynamics_tpu.models import LindbladModel
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve
        from qiskit_dynamics_tpu import Signal, Solver
        from qiskit_dynamics_tpu.quantum_info import DensityMatrix

        nu, gamma = 5.0, 0.1
        Xm = np.array([[0, 1], [1, 0]], dtype=complex)
        Zm = np.diag([1, -1]).astype(complex)
        sm = np.array([[0, 1], [0, 0]], dtype=complex)
        kwargs = dict(
            static_hamiltonian=2 * np.pi * nu * Zm / 2,
            hamiltonian_operators=[2 * np.pi * 0.1 * Xm / 2],
            static_dissipators=[np.sqrt(gamma) * sm],
            rotating_frame=2 * np.pi * nu * Zm / 2,
            vectorized=True,
        )
        model = LindbladModel(**kwargs)
        solver = Solver(**kwargs)
        rho0 = np.zeros((2, 2), dtype=complex)
        rho0[1, 1] = 1.0
        T = 3.0
        amps = jnp.array([0.4, 1.0])
        signals_fn = lambda a: ([Signal(lambda t: a, carrier_freq=nu)], None)
        out = fused_sweep_solve(model, signals_fn, amps, t_span=(0.0, T),
                                max_dt=0.02, y0=rho0)
        assert out.shape == (2, 2, 2)
        for i, a in enumerate([0.4, 1.0]):
            sig = Signal(lambda t, a=a: a, carrier_freq=nu)
            ref = solver.solve(t_span=[0.0, T], y0=DensityMatrix(rho0),
                               signals=[sig], method="DOP853",
                               atol=1e-12, rtol=1e-12)
            np.testing.assert_allclose(
                np.asarray(out[i]), np.asarray(ref.y[-1]), atol=1e-6
            )

    def test_adaptive_glue_rejects_carrier_sweep_and_nonconstant_envelope(self):
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.exceptions import DynamicsError
        import pytest

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        with pytest.raises(DynamicsError, match="carrier"):
            fused_adaptive_sweep_solve(
                solver.model, lambda f: [Signal(lambda t: 0.02, carrier_freq=f)],
                jnp.array([5.0, 5.2]), t_span=(0.0, 1.0), y0=y0,
                tile_b=16, interpret=True, rwa_signal_map=solver._rwa_signal_map,
            )
        with pytest.raises(DynamicsError, match="constant-envelope"):
            fused_adaptive_sweep_solve(
                solver.model, lambda a: [Signal(lambda t: a * np.exp(-t), carrier_freq=w1)],
                jnp.array([0.5, 1.0]), t_span=(0.0, 1.0), y0=y0,
                tile_b=16, interpret=True, rwa_signal_map=solver._rwa_signal_map,
            )


class TestAdaptiveTrajectories:
    def test_t_eval_matches_tpu_dopri5(self):
        """Adaptive steps clip to arbitrary (off-grid) t_eval points; the
        stored trajectory matches the generic adaptive solver, and the
        bucket-lanes permutation is correctly inverted on the batch axis."""
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve
        from qiskit_dynamics_tpu import Signal

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        T = 2.0
        amps = jnp.array([0.9, 0.2, 0.6, 0.4])  # shuffled: bucket un-permute

        def signals_fn(amp):
            return [Signal(lambda t: amp * 0.02, carrier_freq=w1)]

        t_eval = [0.0, 0.7, 1.3, 2.0]
        traj = fused_adaptive_sweep_solve(
            solver.model, signals_fn, amps, t_span=(0.0, T), y0=y0, tile_b=16,
            interpret=True, rwa_signal_map=solver._rwa_signal_map,
            t_eval=t_eval,
        )
        assert traj.shape == (4, 4, 4)
        for b, a in enumerate(np.asarray(amps)):
            sig = Signal(lambda t, a=a: a * 0.02, carrier_freq=w1)
            res = solver.solve(
                t_span=[0.0, T], y0=y0, signals=[sig], method="tpu_dopri5",
                atol=1e-10, rtol=1e-10, t_eval=t_eval,
            )
            np.testing.assert_allclose(
                np.asarray(traj[b]), np.asarray(res.y), atol=5e-6
            )


    def test_t_eval_validation(self):
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.exceptions import DynamicsError
        import pytest

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        amps = jnp.array([0.5, 1.0])

        def signals_fn(amp):
            return [Signal(lambda t: amp * 0.02, carrier_freq=w1)]

        kw = dict(
            t_span=(0.0, 2.0), y0=y0, tile_b=16, interpret=True,
            rwa_signal_map=solver._rwa_signal_map,
        )
        with pytest.raises(DynamicsError, match="increasing"):
            fused_adaptive_sweep_solve(
                solver.model, signals_fn, amps, t_eval=[1.0, 0.5], **kw
            )
        with pytest.raises(DynamicsError, match="within t_span"):
            fused_adaptive_sweep_solve(
                solver.model, signals_fn, amps, t_eval=[1.0, 3.0], **kw
            )
        with pytest.raises(DynamicsError, match="non-empty"):
            fused_adaptive_sweep_solve(
                solver.model, signals_fn, amps, t_eval=[], **kw
            )


class TestFusedAdaptiveLindblad:
    def test_vectorized_lindblad_matches_dop853(self):
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.models import LindbladModel
        from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve, solve_lmde

        X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
        Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
        SM = np.array([[0.0, 1.0], [0.0, 0.0]], dtype=complex)
        nu = 1.0

        def build(vectorized):
            return LindbladModel(
                static_hamiltonian=2 * np.pi * nu * Z / 2,
                hamiltonian_operators=[2 * np.pi * X / 2],
                hamiltonian_signals=[Signal(0.05, carrier_freq=nu)],
                static_dissipators=[0.2 * SM],
                rotating_frame=np.diag(-1j * 2 * np.pi * nu * np.diag(Z) / 2),
                vectorized=vectorized,
            )

        vec = build(True)
        rho0 = np.array([[1.0, 0.0], [0.0, 0.0]], dtype=complex)
        amps = jnp.array([0.3, 1.0])
        sig_fn = lambda a: ([Signal(a * 0.05, carrier_freq=nu)], None)
        out = fused_adaptive_sweep_solve(
            vec, sig_fn, amps, t_span=(0.0, 3.0), y0=rho0, tile_b=16,
            interpret=True,
        )
        assert out.shape == (2, 2, 2)
        for i, a in enumerate([0.3, 1.0]):
            ref_model = build(True)
            ref_model.signals = ([Signal(a * 0.05, carrier_freq=nu)], None)
            res = solve_lmde(
                ref_model, t_span=[0.0, 3.0], y0=rho0.ravel(order="F"),
                method="DOP853", atol=1e-12, rtol=1e-12,
            )
            # solve_lmde already returns standard-basis (frame) values
            ref_rho = np.asarray(res.y[-1]).reshape((2, 2), order="F")
            np.testing.assert_allclose(np.asarray(out[i]), ref_rho, atol=2e-5)


class TestEvalSlotsValidation:
    def _args(self, T=6, n=2, k=1, B=8):
        rng = np.random.default_rng(7)
        H0 = 0.1 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
        ops = 0.1 * (rng.normal(size=(k, n, n)) + 1j * rng.normal(size=(k, n, n)))
        omega = np.zeros((n, n))
        coef = rng.normal(size=(T, 2, k, B))
        y0 = rng.normal(size=(n, B)) + 1j * rng.normal(size=(n, B))
        return H0, ops, omega, coef, y0

    def test_duplicate_and_gapped_slots_rejected(self):
        import pytest
        from qiskit_dynamics_tpu.ops.xla_sweep import sweep_expm_magnus2_xla

        args = self._args()
        kw = dict(dt=0.1)
        # duplicate slot value 0 (slot 1 written twice -> slot semantics broken)
        with pytest.raises(ValueError, match="permutation"):
            sweep_expm_magnus2_xla(*args, eval_slots=(0, -1, 0, -1, -1, 1), **kw)
        # gapped: slot 1 missing -> would return zeros
        with pytest.raises(ValueError, match="permutation"):
            sweep_expm_magnus2_xla(*args, eval_slots=(-1, 0, -1, -1, 2, 3), **kw)
        # valid permutation (not sorted by step is fine) still works
        out, traj = sweep_expm_magnus2_xla(
            *args, eval_slots=(1, -1, 0, -1, -1, 2), **kw
        )
        assert traj.shape[0] == 3


class TestLargePhaseTrig:
    """Phase range reduction (ops/trig_reduce.py): f32 engines must stay
    accurate when frame/carrier phases reach hundreds of radians
    (T * nu >~ 100 carrier cycles — the dim-27 serving regime). Without the
    EFT mod-2pi reduction these configs reach ~4e-3 error; with it they sit
    at the f32 arithmetic floor (~4e-6)."""

    def _config(self):
        rng = np.random.default_rng(3)
        n, k, T, B = 4, 1, 40, 8
        dt, t0 = 0.5, 100.0  # absolute times ~100-120, omega ~30 -> ~3600 rad
        ah = lambda a: (a - a.conj().T) / 2
        H0 = ah(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
        ops = np.array([ah(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))])
        w = rng.normal(size=n) * 30.0
        omega = w[None, :] - w[:, None]
        coef = rng.normal(size=(T, 2, k, B))
        y0 = rng.normal(size=(n, B)) + 1j * rng.normal(size=(n, B))
        return H0, ops, omega, coef, y0, dt, t0, T

    def _f64_reference(self, H0, ops, omega, coef, y0, dt, t0, T, order=10):
        return _magnus2_reference(H0, ops, omega, coef, y0, dt, t0, T, order)

    def test_fixed_step_f32_kernels_match_f64_polynomial(self):
        # must run WITHOUT x64 so the kernels take the f32 reduction path
        import subprocess, sys, os

        code = (
            "import numpy as np\n"
            "from tests.test_batched_linalg import TestLargePhaseTrig\n"
            "t = TestLargePhaseTrig()\n"
            "H0, ops, omega, coef, y0, dt, t0, T = t._config()\n"
            "r = t._f64_reference(H0, ops, omega, coef, y0, dt, t0, T)\n"
            "from qiskit_dynamics_tpu.ops.xla_sweep import sweep_expm_magnus2_xla\n"
            "b = np.asarray(sweep_expm_magnus2_xla(H0, ops, omega, coef, y0,"
            " dt=dt, t0=t0, order=10))\n"
            "eb = np.max(np.abs(b - r))\n"
            "assert eb < 2e-5, f'xla engine large-phase error {eb:.2e}'\n"
            "print('OK', eb)\n"
        )
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            JAX_ENABLE_X64="0",
            PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        env.pop("XLA_FLAGS", None)
        res = subprocess.run(
            [sys.executable, "-c", code], env=env, capture_output=True, text=True,
            timeout=600,
        )
        assert res.returncode == 0, res.stdout + res.stderr

    def test_adaptive_kernel_large_phase(self):
        # the adaptive engines are f32 even under x64: direct interpret-mode
        # check of the Triton kernel
        from qiskit_dynamics_tpu.ops.adaptive_sweep import sweep_dopri5_lockstep
        from qiskit_dynamics_tpu.solvers.adaptive import tpu_dopri5

        rng = np.random.default_rng(11)
        n, B = 4, 16
        t0, tf = 200.0, 204.0
        ah = lambda a: (a - a.conj().T) / 2
        H0 = 0.4 * ah(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
        op = 0.4 * ah(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
        w = rng.normal(size=n) * 25.0  # phases ~ 25 * 204 ~ 5000 rad
        omega = w[None, :] - w[:, None]
        nu = 7.3  # carrier: ~ 1490 cycles by t = 204
        amps = (0.3 + 0.5 * rng.random(B)) * np.exp(2j * np.pi * rng.random(B))
        y0 = np.zeros((n, B), dtype=complex)
        y0[0] = 1.0

        out = np.asarray(
            sweep_dopri5_lockstep(
                H0, op[None], omega, np.array([2 * np.pi * nu]), amps[None, :],
                y0, tf=tf, t0=t0, atol=1e-8, rtol=1e-8, tile_b=16,
                interpret=True, h0=0.01,
            )
        )

        def rhs_factory(amp):
            def rhs(t, y):
                c = jnp.real(amp * jnp.exp(2j * jnp.pi * nu * t))
                G = (jnp.asarray(H0) + c * jnp.asarray(op)) * jnp.exp(
                    1j * jnp.asarray(omega) * t
                )
                return G @ y

            return rhs

        errs = []
        for b in range(B):
            res = tpu_dopri5(
                rhs_factory(amps[b]), (t0, tf), y0[:, b].astype(complex),
                rtol=1e-12, atol=1e-12,
            )
            errs.append(np.max(np.abs(out[:, b] - np.asarray(res.y[-1]))))
        # pre-reduction this config measured ~1e-3; floor is f32 arithmetic
        assert max(errs) < 3e-5, f"adaptive kernel large-phase error {max(errs):.2e}"


class TestAdaptiveDifferentiable:
    """Differentiable lockstep-adaptive sweeps: lockstep primal with
    recorded steps, fixed-grid XLA replay adjoint (ops/adaptive_replay.py)."""

    def _setup(self, T=2.5):
        from qiskit_dynamics_tpu.benchmarks import cr_solver

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        sig_fn = lambda a: [__import__("qiskit_dynamics_tpu").Signal(
            lambda t: a * 0.02, carrier_freq=w1)]
        return solver, sig_fn, y0, T

    def test_primal_identical_through_ad_wrapper(self):
        from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve

        solver, sig_fn, y0, T = self._setup()
        amps = jnp.array([0.4, 0.7, 0.9, 1.0, 0.5, 0.3, 0.6, 0.8])
        kw = dict(
            t_span=(0.0, T), y0=y0, tile_b=16, interpret=True,
            rwa_signal_map=solver._rwa_signal_map,
        )
        a = fused_adaptive_sweep_solve(solver.model, sig_fn, amps, **kw)
        b = fused_adaptive_sweep_solve(
            solver.model, sig_fn, amps, differentiable=False, **kw
        )
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_replay_reproduces_kernel(self):
        # the adjoint's forward replay must track the Triton primal to f32
        # roundoff — that is what makes the VJP the primal's adjoint
        from qiskit_dynamics_tpu.ops.adaptive_sweep import sweep_dopri5_lockstep
        from qiskit_dynamics_tpu.ops.adaptive_replay import dopri5_replay
        from qiskit_dynamics_tpu.ops.trig_reduce import split_array

        rng = np.random.default_rng(2)
        n, B = 4, 16
        t0, tf = 0.5, 3.0
        ah = lambda a: (a - a.conj().T) / 2
        H0 = 0.5 * ah(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
        op = 0.5 * ah(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
        w = rng.normal(size=n) * 3.0
        omega = w[None, :] - w[:, None]
        freqs = np.array([2 * np.pi * 1.1])
        amps = (0.2 + 0.5 * rng.random(B)) * np.exp(2j * np.pi * rng.random(B))
        y0 = rng.normal(size=(n, B)) + 1j * rng.normal(size=(n, B))

        out, rec = sweep_dopri5_lockstep(
            H0, op[None], omega, freqs, amps[None, :], y0, tf=tf, t0=t0,
            atol=1e-7, rtol=1e-7, tile_b=16, interpret=True, h0=0.05,
            record_steps=True, max_steps=512,
        )
        o_hi, o_lo = split_array(omega)
        f_hi, f_lo = split_array(freqs)
        replay = dopri5_replay(
            H0, op[None], o_hi, o_lo, f_hi, f_lo, amps[None, None, :], y0,
            rec, t0=t0, env_dt=tf - t0,
        )
        assert np.asarray(rec).max() > 0  # steps actually recorded
        err = np.max(np.abs(np.asarray(out) - np.asarray(replay)))
        assert err < 5e-6, f"replay deviates from kernel by {err:.2e}"

    def test_gradient_matches_finite_differences(self):
        import jax

        from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve

        solver, sig_fn, y0, T = self._setup()
        amps0 = jnp.array([0.4, 0.7, 0.9, 1.0, 0.5, 0.3, 0.6, 0.8])

        def loss(amps):
            out = fused_adaptive_sweep_solve(
                solver.model, sig_fn, amps, t_span=(0.0, T), y0=y0, tile_b=16,
                interpret=True, rwa_signal_map=solver._rwa_signal_map,
            )
            return jnp.mean(jnp.abs(out[:, 1]) ** 2)

        g = np.asarray(jax.grad(loss)(amps0))
        eps = 3e-4
        for i in (0, 3):
            fd = (loss(amps0.at[i].add(eps)) - loss(amps0.at[i].add(-eps))) / (2 * eps)
            assert abs(g[i] - fd) <= 5e-3 * max(abs(fd), 1e-9), (i, g[i], float(fd))

    def test_trajectory_gradient(self):
        # multi-time calibration objective: grads flow through t_eval stores
        import jax

        from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve

        solver, sig_fn, y0, T = self._setup(T=2.0)
        amps0 = jnp.array([0.5, 0.8, 1.0, 0.4, 0.6, 0.9, 0.3, 0.7])
        t_eval = [0.9, 1.5, 2.0]

        def loss(amps):
            traj = fused_adaptive_sweep_solve(
                solver.model, sig_fn, amps, t_span=(0.0, T), y0=y0, tile_b=16,
                interpret=True, rwa_signal_map=solver._rwa_signal_map,
                t_eval=t_eval,
            )  # (B, n_eval, dim)
            return jnp.mean(jnp.abs(traj[:, :, 1]) ** 2)

        g = np.asarray(jax.grad(loss)(amps0))
        eps = 3e-4
        i = 2
        fd = (loss(amps0.at[i].add(eps)) - loss(amps0.at[i].add(-eps))) / (2 * eps)
        assert abs(g[i] - fd) <= 5e-3 * max(abs(fd), 1e-9), (g[i], float(fd))

    def test_fixed_step_trajectory_gradient(self):
        # trajectory stores of the fixed-step engine are differentiable too
        import jax

        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        solver, sig_fn, y0, T = self._setup(T=2.0)
        amps0 = jnp.array([0.5, 0.8, 1.0, 0.4])

        def loss(amps):
            traj = fused_sweep_solve(
                solver.model, sig_fn, amps, t_span=(0.0, T), max_dt=0.25,
                y0=y0, rwa_signal_map=solver._rwa_signal_map, t_eval=[1.0, 2.0],
            )
            return jnp.mean(jnp.abs(traj[:, :, 1]) ** 2)

        g = np.asarray(jax.grad(loss)(amps0))
        eps = 1e-3
        i = 1
        fd = (loss(amps0.at[i].add(eps)) - loss(amps0.at[i].add(-eps))) / (2 * eps)
        assert abs(g[i] - fd) <= 5e-3 * max(abs(fd), 1e-9), (g[i], float(fd))


def _lockstep_problem(n, k=2, B=32, seed=0):
    rng = np.random.default_rng(seed)
    ah = lambda a: (a - a.conj().T) / 2
    H0 = 0.4 * ah(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    ops = np.stack(
        [0.3 * ah(rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))) for _ in range(k)]
    )
    w = rng.normal(size=n) * 4.0
    omega = w[None, :] - w[:, None]
    freqs = 2 * np.pi * rng.uniform(0.5, 1.5, size=k)
    y0 = rng.normal(size=(n, B)) + 1j * rng.normal(size=(n, B))
    y0 /= np.linalg.norm(y0, axis=0)
    return rng, H0, ops, omega, freqs, y0


class TestLockstepEngines:
    """The Triton kernel (Pallas interpreter) against its XLA twin, with the
    same controller and the same per-group grouping."""

    @pytest.mark.parametrize("n", [2, 4, 8, 16, 27])
    @pytest.mark.parametrize("mode", ["constant", "table", "t_eval"])
    def test_triton_matches_xla(self, n, mode):
        from qiskit_dynamics_tpu.ops.adaptive_sweep import sweep_dopri5_lockstep

        k, B, t0, tf = 2, 32, 0.25, 1.5
        rng, H0, ops, omega, freqs, y0 = _lockstep_problem(n, k, B, seed=n)
        kw = dict(
            tf=tf, t0=t0, atol=1e-6, rtol=1e-6, h0=0.05, tile_b=16,
            record_steps=True, max_steps=256,
        )
        if mode == "table":
            S = 5
            amps = rng.normal(size=(k, S, B)) + 1j * rng.normal(size=(k, S, B))
            kw["env_dt"] = (tf - t0) / S
        else:
            amps = rng.normal(size=(k, B)) + 1j * rng.normal(size=(k, B))
        if mode == "t_eval":
            kw["eval_ts"] = (0.4, 0.9, tf - t0)
        args = (H0, ops, omega, freqs, amps, y0)
        out_x, rec_x = sweep_dopri5_lockstep(*args, engine="xla", **kw)
        out_t, rec_t = sweep_dopri5_lockstep(*args, interpret=True, **kw)
        # at tol 1e-6 the f32 error estimate carries ~1% roundoff, so the
        # engines' step sizes drift apart at that level (a final sliver
        # step may appear in one of them); the states agree to the
        # integration accuracy
        steps_x = (np.asarray(rec_x) > 0).sum(axis=1)
        steps_t = (np.asarray(rec_t) > 0).sum(axis=1)
        assert steps_x.min() > 3 and np.abs(steps_x - steps_t).max() <= 1
        np.testing.assert_allclose(
            np.asarray(rec_t).sum(axis=1), tf - t0, rtol=1e-6
        )
        pairs = zip(out_t, out_x) if mode == "t_eval" else [(out_t, out_x)]
        for a, b in pairs:
            assert a.shape == b.shape and np.isfinite(np.asarray(a)).all()
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)

    @pytest.mark.parametrize("y0_kind", ["vector", "matrix"])
    def test_public_entry_engines_agree(self, y0_kind):
        """``fused_adaptive_sweep_solve``: ``interpret=True`` (Triton kernel)
        and the CPU default (XLA engine) agree for vector and 2-d ``y0``."""
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve
        from qiskit_dynamics_tpu import Signal

        solver, w1 = cr_solver(dim=2)
        y0 = np.eye(4, dtype=complex) if y0_kind == "matrix" else np.eye(4)[0].astype(complex)
        amps = jnp.array([0.3, 0.9, 0.6])
        kw = dict(
            t_span=(0.0, 2.0), y0=y0, tile_b=16, rwa_signal_map=solver._rwa_signal_map,
        )
        fn = lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)]
        a = fused_adaptive_sweep_solve(solver.model, fn, amps, interpret=True, **kw)
        b = fused_adaptive_sweep_solve(solver.model, fn, amps, **kw)
        assert a.shape == b.shape == ((3, 4, 4) if y0_kind == "matrix" else (3, 4))
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-6)

    @pytest.mark.parametrize(
        "n,n_pad", [(1, 16), (2, 16), (16, 16), (17, 32), (27, 32), (64, 64)]
    )
    def test_pad_dim(self, n, n_pad):
        from qiskit_dynamics_tpu.ops.adaptive_sweep import _pad_dim

        assert _pad_dim(n) == n_pad

    @pytest.mark.parametrize(
        "n,tile_b,warps", [(2, 32, 8), (16, 32, 8), (17, 16, 8), (27, 16, 8), (64, 16, 16)]
    )
    def test_default_group_size(self, n, tile_b, warps):
        """A (n_pad, tile_b) block of 512 elements up to dim 32, two block
        elements per thread."""
        from qiskit_dynamics_tpu.ops.adaptive_sweep import (
            _pad_dim, _triton_warps, lockstep_tile_b,
        )

        assert lockstep_tile_b(n) == tile_b
        assert _triton_warps(_pad_dim(n), tile_b) == warps

    @pytest.mark.parametrize("dim,tile_b", [(2, 32), (5, 16)])
    def test_public_entry_resolves_group_size(self, dim, tile_b):
        """``adaptive_sweep_inputs`` pads the lanes to the default group of
        its solve dimension and reports it among the engine's statics."""
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers.fused_sweep import adaptive_sweep_inputs

        solver, w1 = cr_solver(dim=dim)
        y0 = np.eye(dim * dim)[0].astype(complex)
        fn = lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)]
        args, statics, _ = adaptive_sweep_inputs(
            solver.model, fn, jnp.array([0.3, 0.9, 0.6]), (0.0, 2.0), y0,
            rwa_signal_map=solver._rwa_signal_map,
        )
        assert statics["tile_b"] == tile_b
        assert args[-1].shape == (dim * dim, tile_b)

    def test_engine_choice(self):
        from qiskit_dynamics_tpu.ops.adaptive_sweep import lockstep_engine

        # the suite runs on the CPU: XLA twin unless the interpreter is asked
        assert lockstep_engine() == "xla"
        assert lockstep_engine(interpret=True) == "triton"

    @pytest.mark.parametrize("tile_b", [8, 24])
    def test_triton_rejects_bad_tile(self, tile_b):
        from qiskit_dynamics_tpu.ops.adaptive_sweep import sweep_dopri5_lockstep

        _, H0, ops, omega, freqs, y0 = _lockstep_problem(2, 1, 48)
        with pytest.raises(ValueError, match="tile_b"):
            sweep_dopri5_lockstep(
                H0, ops, omega, freqs, np.ones((1, 48), complex), y0, tf=1.0,
                tile_b=tile_b, interpret=True,
            )

    def test_finish_poisons_failed_groups_and_masks_record(self):
        from qiskit_dynamics_tpu.ops.adaptive_sweep import _finish

        y = jnp.ones((4, 32), jnp.complex64)
        rec = jnp.full((2, 5), 7.0, jnp.float32)  # garbage past the count
        info = jnp.array([[1, 9, 3], [0, 9, 2]], jnp.int32)
        out, steps = _finish((y, None, rec, info), 3, 16, True, 0)
        out = np.asarray(out)
        assert out.shape == (3, 32)
        assert np.all(out[:, :16] == 1) and np.isnan(out[:, 16:]).all()
        np.testing.assert_array_equal(
            np.asarray(steps), [[7, 7, 7, 0, 0], [7, 7, 0, 0, 0]]
        )

    def test_replay_reproduces_xla_engine(self):
        """The AD replay re-integrates the XLA engine's recorded grid."""
        from qiskit_dynamics_tpu.ops.adaptive_sweep import sweep_dopri5_lockstep
        from qiskit_dynamics_tpu.ops.adaptive_replay import dopri5_replay
        from qiskit_dynamics_tpu.ops.trig_reduce import split_array

        rng, H0, ops, omega, freqs, y0 = _lockstep_problem(3, 1, 32, seed=9)
        amps = rng.normal(size=(1, 32)) + 1j * rng.normal(size=(1, 32))
        out, rec = sweep_dopri5_lockstep(
            H0, ops, omega, freqs, amps, y0, tf=2.0, t0=0.5, atol=1e-7,
            rtol=1e-7, tile_b=16, h0=0.05, record_steps=True, max_steps=512,
            engine="xla",
        )
        o_hi, o_lo = split_array(omega)
        f_hi, f_lo = split_array(freqs)
        replay = dopri5_replay(
            H0, ops, o_hi, o_lo, f_hi, f_lo, amps[:, None, :], y0, rec,
            t0=0.5, env_dt=1.5,
        )
        err = np.max(np.abs(np.asarray(out) - np.asarray(replay)))
        assert err < 5e-6, f"replay deviates from the XLA engine by {err:.2e}"


@pytest.mark.parametrize(
    "solve_dim,engine",
    [(2, "xla"), (16, "xla"), (27, "xla"), (64, "xla"), (128, "xla"), (129, "poly"), (256, "poly")],
)
def test_fixed_step_engine_choice_by_dim(solve_dim, engine):
    from qiskit_dynamics_tpu.solvers.fused_sweep import _auto_sweep_engine

    assert _auto_sweep_engine(solve_dim) == engine


class TestLockstepController:
    """The step controller shared by the Triton kernel and its XLA twin."""

    def _clip(self, **kw):
        from qiskit_dynamics_tpu.ops.adaptive_sweep import _clip_step

        args = dict(
            s_hi=jnp.float32(0.3), s_lo=jnp.float32(0.0), h_prop=jnp.float32(0.5),
            eidx=jnp.int32(0), dur=(jnp.float32(2.0), jnp.float32(0.0)), n_eval=0,
            target_at=None, n_env=1, env_dt=2.0,
        )
        args.update(kw)
        return _clip_step(**args)

    def test_step_clipped_to_remaining_time(self):
        h, cell, _, _ = self._clip(s_hi=jnp.float32(1.8))
        assert float(h) == pytest.approx(0.2, rel=1e-6) and int(cell) == 0

    def test_step_clipped_to_envelope_cell(self):
        # cells of width 0.25: t = 0.3 sits in cell 1, whose edge is 0.5
        h, cell, _, _ = self._clip(n_env=8, env_dt=0.25)
        assert float(h) == pytest.approx(0.2, rel=1e-6) and int(cell) == 1

    def test_step_clipped_to_trajectory_time(self):
        targets = jnp.array([0.45, 1.0], jnp.float32)
        h, _, target, have = self._clip(n_eval=2, target_at=lambda i: targets[i])
        assert float(h) == pytest.approx(0.15, rel=1e-5)
        assert float(target) == pytest.approx(0.45) and bool(have)

    @pytest.mark.parametrize(
        "err,accept,grows",
        [(0.5, True, True), (2.0, False, False), (1e-12, True, True)],
    )
    def test_accept_and_next_proposal(self, err, accept, grows):
        from qiskit_dynamics_tpu.ops.adaptive_sweep import _adapt

        h = jnp.float32(0.1)
        acc, bad, h_new = _adapt(h, h, jnp.float32(err), jnp.float32(1.0), False)
        assert bool(acc) == accept and not bool(bad)
        assert (float(h_new) > 0.1) == grows
        assert 0.02 - 1e-9 <= float(h_new) <= 1.0 + 1e-6  # factor in [0.2, 10]

    def test_stalled_step_is_accepted_and_flagged(self):
        from qiskit_dynamics_tpu.ops.adaptive_sweep import _adapt

        h = jnp.float32(1e-9)
        acc, bad, _ = _adapt(h, h, jnp.float32(1e3), jnp.float32(1.0), False)
        assert bool(acc) and bool(bad)


@pytest.mark.parametrize("n", [3, 8])
def test_lockstep_rhs_matches_dense_generator(n):
    """``G(t) y`` via the diagonal frame conjugation equals the dense
    Hadamard-phase generator ``(e^{i omega t} o (S + sum_j c_j O_j)) y``."""
    from qiskit_dynamics_tpu.ops.adaptive_sweep import lockstep_rhs
    from qiskit_dynamics_tpu.ops.trig_reduce import split_array, split_const

    rng, H0, ops, omega, freqs, y0 = _lockstep_problem(n, 2, 4, seed=3)
    amps = rng.normal(size=(2, 1, 4)) + 1j * rng.normal(size=(2, 1, 4))
    w = omega[0]
    rhs = lockstep_rhs(
        jnp.asarray(H0, jnp.complex64), jnp.asarray(ops, jnp.complex64),
        tuple(jnp.asarray(a) for a in split_array(w)),
        tuple(jnp.asarray(a) for a in split_array(freqs)),
        split_const(0.2), jnp.asarray(amps.reshape(2, 1, 1, 4), jnp.complex64),
    )
    s = 0.7
    y = jnp.asarray(y0.T[None], jnp.complex64)  # (L=1, Bt=4, n)
    out = np.asarray(rhs(y, (jnp.full(1, s, jnp.float32), jnp.zeros(1, jnp.float32)),
                         jnp.zeros(1, jnp.int32)))[0]
    t = 0.2 + s
    for b in range(4):
        c = np.real(amps[:, 0, b] * np.exp(1j * freqs * t))
        G = np.exp(1j * omega * t) * (H0 + np.tensordot(c, ops, axes=1))
        np.testing.assert_allclose(out[b], G @ y0[:, b], atol=2e-5)
