"""df32 compensated arithmetic + high-precision sweep path.

The contract tests exist to fail loudly if a backend/compiler change breaks
the error-free transformations (e.g. FMA contraction or algebraic
simplification of EFT patterns — both observed on XLA CPU; see
ops/df32.py). Accuracy bar: the reference's cross-method agreement is
rtol=atol=1e-8 (/root/reference/test/dynamics/common.py:65); df32 must
deliver that WITHOUT float64 device support.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qiskit_dynamics_tpu.ops import df32


class TestDf32Contract:
    def test_two_sum_exact(self):
        rng = np.random.default_rng(0)
        a = rng.standard_normal(256).astype(np.float32)
        b = (rng.standard_normal(256) * 1e-5).astype(np.float32)
        s, e = jax.jit(df32.two_sum)(a, b)
        ref = a.astype(np.float64) + b.astype(np.float64)
        np.testing.assert_array_equal(
            np.asarray(s, np.float64) + np.asarray(e, np.float64), ref
        )

    def test_two_prod_near_exact(self):
        rng = np.random.default_rng(1)
        a = rng.standard_normal(256).astype(np.float32)
        b = rng.standard_normal(256).astype(np.float32)
        p, e = jax.jit(df32.two_prod)(a, b)
        ref = a.astype(np.float64) * b.astype(np.float64)
        got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
        # p + e == a*b up to O(eps^2 * |ab|)
        assert np.max(np.abs(got - ref) / np.abs(ref)) < 1e-13

    def test_mul_broadcast_under_jit(self):
        # regression: XLA CPU FMA-contracts inexact fmuls into fadds inside
        # broadcast fusions; the bitmask-split two_prod must be immune
        rng = np.random.default_rng(3)
        a64 = rng.standard_normal((4, 4)) * 0.1
        b64 = rng.standard_normal((8,))
        adf = df32.from_f64(a64)
        bdf = df32.from_f64(b64)
        out = jax.jit(
            lambda x, y: df32.mul(
                (x[0][:, :, None], x[1][:, :, None]),
                (y[0][None, None, :], y[1][None, None, :]),
            )
        )(adf, bdf)
        ref = a64[:, :, None] * b64[None, None, :]
        assert np.max(np.abs(df32.to_f64(out) - ref)) < 1e-14

    def test_dependent_chain_in_scan(self):
        # loops compile through different emitters than straightline code;
        # the EFT contract must hold there too
        rng = np.random.default_rng(4)
        a64 = rng.standard_normal(64) * 0.5
        b64 = rng.standard_normal(64) * 0.5
        x = df32.from_f64(a64)
        y = df32.from_f64(b64)

        @jax.jit
        def chain(x, y):
            def body(carry, _):
                z = df32.mul(carry, y)
                z = df32.add(z, x)
                return z, None

            out, _ = jax.lax.scan(body, x, None, length=40)
            return out

        got = df32.to_f64(chain(x, y))
        ref = a64.copy()
        for _ in range(40):
            ref = ref * b64 + a64
        assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)) < 1e-12

    def test_cancellation_accuracy(self):
        # accurate dd-add must survive near-total cancellation
        a = df32.from_f64(np.array([1.0 + 1e-9]))
        b = df32.from_f64(np.array([-1.0 + 1e-9]))
        out = df32.to_f64(jax.jit(df32.add)(a, b))
        expected = df32.to_f64(a) + df32.to_f64(b)  # ~2e-9 after cancellation
        np.testing.assert_allclose(out, expected, rtol=1e-10)

    def test_complex_mul(self):
        rng = np.random.default_rng(5)
        a = rng.standard_normal(32) + 1j * rng.standard_normal(32)
        b = rng.standard_normal(32) + 1j * rng.standard_normal(32)
        out = jax.jit(df32.cmul)(df32.cfrom_f64(a), df32.cfrom_f64(b))
        assert np.max(np.abs(df32.cto_f64(out) - a * b)) < 1e-13


class TestDfSweep:
    def _problem(self):
        rng = np.random.default_rng(3)
        n, k, B = 4, 2, 8
        H0 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        static = -1j * (H0 + H0.conj().T) / 2 * 0.3
        ops = np.array(
            [
                -1j * ((A + A.conj().T) / 2) * 0.1
                for A in (
                    rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
                    for _ in range(k)
                )
            ]
        )
        omega = rng.standard_normal((n, n)) * 0.5
        omega = omega - omega.T
        amps = rng.standard_normal((k, B))
        freqs = np.array([1.3, 0.7])
        y0 = np.zeros((n, B), dtype=complex)
        y0[0] = 1.0
        y0[1, :] = 0.3j
        y0 /= np.linalg.norm(y0, axis=0)
        return n, k, B, static, ops, omega, amps, freqs, y0

    def test_matches_dop853_to_1e_9(self):
        from scipy.integrate import solve_ivp

        from qiskit_dynamics_tpu.ops.df_sweep import MAGNUS_NODES, sweep_expm_magnus_df

        n, k, B, static, ops, omega, amps, freqs, y0 = self._problem()
        t0, tf, dt = 0.5, 4.5, 0.0125
        T = int(round((tf - t0) / dt))
        tau = t0 + dt * (np.arange(T)[:, None] + MAGNUS_NODES[2][None, :])
        coefs = amps[None, None] * np.cos(
            freqs[None, None, :, None] * tau[:, :, None, None]
        )
        out = sweep_expm_magnus_df(
            static, ops, omega, coefs, y0, dt=dt, t0=t0, magnus_order=2, chunk_b=8
        )

        def rhs_factory(b):
            def rhs(t, y):
                G = static + np.tensordot(amps[:, b] * np.cos(freqs * t), ops, axes=1)
                return (G * np.exp(1j * omega * t)) @ y

            return rhs

        ref = np.stack(
            [
                solve_ivp(
                    rhs_factory(b), (t0, tf), y0[:, b], method="DOP853",
                    rtol=1e-13, atol=1e-13,
                ).y[:, -1]
                for b in range(B)
            ],
            axis=1,
        )
        assert out.dtype == np.complex128
        assert np.max(np.abs(out - ref)) < 1e-9


class TestFusedSweepDf32:
    def test_cr_sweep_1e_8_agreement(self):
        """BASELINE.md bar: fused sweep agrees with DOP853 to 1e-8."""
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        amps = np.array([0.3, 0.7, 1.0])
        T = 5.0
        out = fused_sweep_solve(
            solver.model,
            lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)],
            amps, t_span=(0.0, T), max_dt=0.025, y0=y0,
            rwa_signal_map=solver._rwa_signal_map, precision="df32", df_chunk_b=8,
        )
        assert out.dtype == np.complex128
        for i, a in enumerate(amps):
            ref = solver.solve(
                t_span=[0.0, T], y0=y0,
                signals=[Signal(lambda t, a=a: a * 0.02, carrier_freq=w1)],
                method="DOP853", atol=1e-13, rtol=1e-13,
            )
            np.testing.assert_allclose(
                out[i], np.asarray(ref.y[-1]), rtol=1e-8, atol=1e-8
            )

    def test_t0_nonzero_matches_dop853(self):
        """t_span[0] != 0 (restriction lifted) for both precisions."""
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 0.6
        y0[1] = 0.8
        amps = np.array([0.5, 1.0])
        t_span = (1.25, 4.75)
        sig_fn = lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)]
        refs = [
            np.asarray(
                solver.solve(
                    t_span=list(t_span), y0=y0, signals=sig_fn(float(a)),
                    method="DOP853", atol=1e-13, rtol=1e-13,
                ).y[-1]
            )
            for a in amps
        ]
        out_df = fused_sweep_solve(
            solver.model, sig_fn, amps, t_span=t_span, max_dt=0.025, y0=y0,
            rwa_signal_map=solver._rwa_signal_map, precision="df32", df_chunk_b=8,
        )
        np.testing.assert_allclose(out_df, np.stack(refs), rtol=1e-8, atol=1e-8)

        out_f32 = fused_sweep_solve(
            solver.model, sig_fn, jnp.asarray(amps), t_span=t_span, max_dt=0.05,
            y0=y0, rwa_signal_map=solver._rwa_signal_map,
        )
        np.testing.assert_allclose(np.asarray(out_f32), np.stack(refs), atol=2e-5)

    def test_t0_nonzero_adaptive(self):
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_adaptive_sweep_solve

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        amps = jnp.array([0.4, 0.9])
        t_span = (0.75, 3.25)
        sig_fn = lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)]
        out = fused_adaptive_sweep_solve(
            solver.model, sig_fn, amps, t_span=t_span, y0=y0, tile_b=16,
            interpret=True, rwa_signal_map=solver._rwa_signal_map,
        )
        for i, a in enumerate([0.4, 0.9]):
            ref = solver.solve(
                t_span=list(t_span), y0=y0, signals=sig_fn(a),
                method="DOP853", atol=1e-12, rtol=1e-12,
            )
            np.testing.assert_allclose(
                np.asarray(out[i]), np.asarray(ref.y[-1]), atol=2e-5
            )

    def test_df32_rejects_traced_params(self):
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.exceptions import DynamicsError
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0

        def run(amps):
            return fused_sweep_solve(
                solver.model,
                lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)],
                amps, t_span=(0.0, 1.0), max_dt=0.1, y0=y0, precision="df32",
                rwa_signal_map=solver._rwa_signal_map,
            )

        with pytest.raises(DynamicsError, match="concrete"):
            jax.jit(run)(jnp.array([0.5, 1.0]))


class TestHermitianCommutator:
    """The one-matmul anti-Hermitian commutator path must match the general
    two-matmul path (here: bit-identical on CPU)."""

    @pytest.mark.parametrize("magnus_order", [2, 3])
    def test_matches_general_path(self, magnus_order):
        from qiskit_dynamics_tpu.ops.df_sweep import MAGNUS_NODES, sweep_expm_magnus_df

        rng = np.random.default_rng(5)
        n, k, B = 4, 2, 8
        H0 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        static = -1j * (H0 + H0.conj().T) / 2 * 0.3
        ops = np.array(
            [
                -1j * ((A + A.conj().T) / 2) * 0.1
                for A in (
                    rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
                    for _ in range(k)
                )
            ]
        )
        omega = rng.standard_normal((n, n)) * 0.5
        omega = omega - omega.T
        amps = rng.standard_normal((k, B))
        freqs = np.array([1.3, 0.7])
        t0, dt, T = 0.5, 0.05, 40
        tau = t0 + dt * (np.arange(T)[:, None] + MAGNUS_NODES[magnus_order][None, :])
        coefs = amps[None, None] * np.cos(
            freqs[None, None, :, None] * tau[:, :, None, None]
        )
        y0 = np.zeros((n, B), dtype=complex)
        y0[0] = 1.0
        # bit-level claim holds on the full-df path (fast commutators
        # evaluate the shortcut in f32, where the two orderings differ at
        # f32 roundoff of the small correction terms)
        kw = dict(
            dt=dt, t0=t0, magnus_order=magnus_order, chunk_b=8,
            fast_commutators=False, horner_df_tail=0,
        )
        a = sweep_expm_magnus_df(static, ops, omega, coefs, y0, hermitian=False, **kw)
        b = sweep_expm_magnus_df(static, ops, omega, coefs, y0, hermitian=True, **kw)
        np.testing.assert_allclose(a, b, atol=1e-13)

    def test_fast_path_matches_full_df(self):
        """The mixed-precision defaults (f32 commutators + f32 Horner head)
        must stay within ~1e-10 of the full-df engine on a representative
        chain — the budget that keeps the 1e-8 BASELINE bar."""
        from qiskit_dynamics_tpu.ops.df_sweep import MAGNUS_NODES, sweep_expm_magnus_df

        rng = np.random.default_rng(5)
        n, k, B = 4, 2, 8
        H0 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        static = -1j * (H0 + H0.conj().T) / 2 * 0.3
        ops = np.array(
            [
                -1j * ((A + A.conj().T) / 2) * 0.1
                for A in (
                    rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
                    for _ in range(k)
                )
            ]
        )
        omega = rng.standard_normal((n, n)) * 0.5
        omega = omega - omega.T
        amps = rng.standard_normal((k, B))
        freqs = np.array([1.3, 0.7])
        t0, dt, T = 0.0, 0.2, 100  # 100 steps at the production dt
        tau = t0 + dt * (np.arange(T)[:, None] + MAGNUS_NODES[3][None, :])
        coefs = amps[None, None] * np.cos(
            freqs[None, None, :, None] * tau[:, :, None, None]
        )
        y0 = np.zeros((n, B), dtype=complex)
        y0[0] = 1.0
        kw = dict(dt=dt, t0=t0, magnus_order=3, chunk_b=8, hermitian=True)
        full = sweep_expm_magnus_df(
            static, ops, omega, coefs, y0, fast_commutators=False,
            horner_df_tail=0, **kw,
        )
        fast = sweep_expm_magnus_df(static, ops, omega, coefs, y0, **kw)
        # measured ~2e-10 on this 100-step chain — an order below the 1e-8 bar
        assert np.max(np.abs(fast - full)) < 1e-9

    def test_per_step_dt_grid(self):
        """A non-uniform dt grid must agree with DOP853 (the host-adaptive
        grid path) and reject bad shapes."""
        from scipy.integrate import solve_ivp

        from qiskit_dynamics_tpu.ops.df_sweep import MAGNUS_NODES, sweep_expm_magnus_df

        rng = np.random.default_rng(7)
        n, k, B = 3, 1, 4
        H0 = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        static = -1j * (H0 + H0.conj().T) / 2 * 0.4
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        ops = np.array([-1j * (A + A.conj().T) / 2 * 0.2])
        omega = np.zeros((n, n))
        amps = rng.standard_normal((k, B))
        freqs = np.array([0.9])
        t0 = 0.25
        dts = np.concatenate([np.full(30, 0.02), np.full(20, 0.05), np.full(10, 0.03)])
        T = dts.size
        t_start = t0 + np.concatenate([[0.0], np.cumsum(dts)[:-1]])
        tau = t_start[:, None] + dts[:, None] * MAGNUS_NODES[3][None, :]
        coefs = amps[None, None] * np.cos(
            freqs[None, None, :, None] * tau[:, :, None, None]
        )
        y0 = np.zeros((n, B), dtype=complex)
        y0[0] = 1.0
        out = sweep_expm_magnus_df(
            static, ops, omega, coefs, y0, dt=dts, t0=t0, magnus_order=3, chunk_b=4
        )
        tf = t0 + float(np.sum(dts))
        for b in range(B):
            ref = solve_ivp(
                lambda t, y, b=b: (
                    static + amps[0, b] * np.cos(freqs[0] * t) * ops[0]
                ) @ y,
                (t0, tf), y0[:, b], method="DOP853", rtol=1e-13, atol=1e-13,
            ).y[:, -1]
            assert np.max(np.abs(out[:, b] - ref)) < 1e-9

        with pytest.raises(ValueError, match="shape"):
            sweep_expm_magnus_df(
                static, ops, omega, coefs, y0, dt=dts[:-1], t0=t0, magnus_order=3
            )


class TestConstEnvelopeFastPath:
    """The constant-envelope compact-table path (device broadcast instead of
    shipping (T, n_nodes, k, B); round-3 transfer fix) must give results
    IDENTICAL to the full-table path."""

    def test_const_table_matches_full_table(self):
        from qiskit_dynamics_tpu.ops.df_sweep import MAGNUS_NODES, sweep_expm_magnus_df

        rng = np.random.default_rng(77)
        n, k, B = 4, 2, 6
        static = -1j * (lambda a: (a + a.conj().T) / 2)(
            rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        )
        ops = np.stack([
            -1j * (lambda a: (a + a.conj().T) / 2)(
                rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
            ) * 0.3
            for _ in range(k)
        ])
        w = rng.standard_normal(n)
        omega = w[None, :] - w[:, None]
        y0 = rng.standard_normal((n, B)) + 1j * rng.standard_normal((n, B))
        dt, T = 0.05, 11
        amps = rng.standard_normal((k, B))
        # exactly constant along (T, n_nodes): triggers the compact path
        coefs_const = np.broadcast_to(
            amps[None, None], (T, len(MAGNUS_NODES[2]), k, B)
        ).copy()
        out_const = sweep_expm_magnus_df(
            static, ops, omega, coefs_const, y0, dt=dt, magnus_order=2, chunk_b=4
        )
        # force the full-table path with a 1-ulp perturbation of a single
        # sample (defeats the exact-constancy detection; its numerical
        # effect is far below the comparison tolerance)
        coefs_full = coefs_const.copy()
        coefs_full[0, 0, 0, 0] = coefs_full[0, 0, 0, 0] * (1 + 1e-14)
        out_full = sweep_expm_magnus_df(
            static, ops, omega, coefs_full, y0, dt=dt, magnus_order=2, chunk_b=4
        )
        assert np.max(np.abs(out_const - out_full)) < 1e-10


class TestFactorizedCoefficients:
    """Round-3 transfer optimization: constant-envelope sweeps ship (k, R, B)
    amplitude factors + tiny phase tables and assemble the coefficient table
    on device in df32 (``coef_factors=``), instead of the full
    (T, n_nodes, k, B) host table. Must agree with the full-table path to df
    roundoff."""

    def _cr_setup(self, B=10):
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.benchmarks import cr_solver

        solver, w1 = cr_solver()
        y0 = np.zeros(16, dtype=complex)
        y0[0] = 1.0

        def signals_fn(amp):
            return [Signal(lambda t: amp * 0.02, carrier_freq=w1)]

        amps = np.linspace(0.25, 1.0, B)
        return solver, signals_fn, amps, y0

    def test_extraction_on_cr_config(self):
        """The RWA-mapped CR drive factorizes (constant envelopes)."""
        from qiskit_dynamics_tpu.solvers import fused_sweep as fs
        from qiskit_dynamics_tpu.signals import SignalList

        solver, signals_fn, amps, _ = self._cr_setup(B=7)
        k = solver.model.operators.shape[0]

        def signals_as_list(p):
            return SignalList(list(solver._rwa_signal_map(signals_fn(p))))

        factors = fs._constant_envelope_factors(
            signals_as_list, amps, np.array([0.0, 1.7, 31.4]), k, 7
        )
        assert factors is not None
        A, carriers = factors
        assert A.shape[0] == k and A.shape[2] == 7
        assert carriers.shape == A.shape[:2]
        # reconstruction matches the signal machinery at an arbitrary time
        t = 2.31
        ref = np.stack(
            [
                np.asarray(
                    signals_as_list(
                        jax.tree_util.tree_map(lambda x: x[b], amps)
                    )(t)
                )
                for b in range(7)
            ],
            axis=-1,
        )  # (k, 7)
        rec = np.real(
            np.sum(A * np.exp(2j * np.pi * carriers * t)[..., None], axis=1)
        )
        np.testing.assert_allclose(rec, ref, atol=1e-12, rtol=0.0)

    def test_factor_path_matches_full_table(self):
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve
        from qiskit_dynamics_tpu.solvers import fused_sweep as fs

        solver, signals_fn, amps, y0 = self._cr_setup(B=10)
        kw = dict(
            t_span=(0.0, 10.0), max_dt=0.2, y0=y0,
            rwa_signal_map=solver._rwa_signal_map, precision="df32",
        )
        out_fac = fused_sweep_solve(solver.model, signals_fn, amps, **kw)
        orig = fs._constant_envelope_factors
        fs._constant_envelope_factors = lambda *a, **k: None
        try:
            out_full = fused_sweep_solve(solver.model, signals_fn, amps, **kw)
        finally:
            fs._constant_envelope_factors = orig
        assert np.max(np.abs(out_fac - out_full)) < 1e-11

    def test_time_dependent_envelope_bails(self):
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.signals import SignalList
        from qiskit_dynamics_tpu.solvers import fused_sweep as fs

        def signals_as_list(p):
            return SignalList(
                [Signal(lambda t: p * np.exp(-(t**2)), carrier_freq=5.0)]
            )

        amps = np.linspace(0.1, 1.0, 5)
        assert (
            fs._constant_envelope_factors(
                signals_as_list, amps, np.array([0.0, 0.5, 1.0]), 1, 5
            )
            is None
        )

    def test_per_member_carrier_bails(self):
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.signals import SignalList
        from qiskit_dynamics_tpu.solvers import fused_sweep as fs

        freqs = np.linspace(4.9, 5.1, 5)

        def signals_as_list(p):
            return SignalList([Signal(lambda t: 0.3, carrier_freq=p)])

        assert (
            fs._constant_envelope_factors(
                signals_as_list, freqs, np.array([0.0, 0.5, 1.0]), 1, 5
            )
            is None
        )

    def test_coef_factors_validation(self):
        from qiskit_dynamics_tpu.ops.df_sweep import sweep_expm_magnus_df

        n, k, B = 2, 1, 3
        static = np.zeros((n, n), dtype=complex)
        ops = np.zeros((k, n, n), dtype=complex)
        omega = np.zeros((n, n))
        y0 = np.ones((n, B), dtype=complex)
        A = np.ones((k, 1, B), dtype=complex)
        carr = np.zeros((k, 1))
        dts = np.full(4, 0.1)
        with pytest.raises(ValueError, match="not both"):
            sweep_expm_magnus_df(
                static, ops, omega, np.zeros((4, 3, k, B)), y0, dt=dts,
                coef_factors=(A, carr),
            )
        with pytest.raises(ValueError, match=r"\(T,\) per-step array"):
            sweep_expm_magnus_df(
                static, ops, omega, None, y0, dt=0.1, coef_factors=(A, carr)
            )
        with pytest.raises(ValueError, match="amplitudes"):
            sweep_expm_magnus_df(
                static, ops, omega, None, y0, dt=dts,
                coef_factors=(np.ones((k + 1, 1, B)), carr),
            )
        with pytest.raises(ValueError, match="carriers"):
            sweep_expm_magnus_df(
                static, ops, omega, None, y0, dt=dts,
                coef_factors=(A, np.zeros((k, 2))),
            )

    def test_frame_phase_diag_product(self):
        """Device df32 phasor product tracks the host-f64 phase tables.

        The agreement floor is set by f64 ARGUMENT rounding of the large
        phases, not by the df arithmetic: at |phase| ~ 3200 rad each
        ``v * tau`` product rounds to ~ulp(3200) ~ 7e-13 rad, and the two
        formulations round differently — both are within ~1e-12 of the true
        value (far below the engine's 1e-8 target)."""
        from qiskit_dynamics_tpu.ops.df_sweep import _frame_phases_from_diag

        rng = np.random.default_rng(3)
        n, T, nodes = 5, 4, 3
        v = rng.uniform(-40.0, 40.0, n)
        tau = np.sort(rng.uniform(0.0, 80.0, (T, nodes)), axis=None).reshape(T, nodes)
        phv = v[None, None, :] * tau[:, :, None]
        cos_m, sin_m = _frame_phases_from_diag(
            df32.from_f64(np.cos(phv)), df32.from_f64(np.sin(phv))
        )
        omega = v[None, :] - v[:, None]
        ph = omega[None, None] * tau[:, :, None, None]
        np.testing.assert_allclose(
            df32.to_f64(cos_m), np.cos(ph), atol=5e-12, rtol=0.0
        )
        np.testing.assert_allclose(
            df32.to_f64(sin_m), np.sin(ph), atol=5e-12, rtol=0.0
        )


class TestRank1EnvelopeFactors:
    """Fixed-shape envelope sweeps (amplitude/phase calibration of a
    time-varying pulse) factorize as one reference profile P (T, nodes, k, R)
    + per-member complex scales A (k, R, B): the df32 engine combines them on
    device (``coef_factors=(A, P)``), keeping transfer O(T + B)."""

    def _gauss_setup(self):
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.signals import SignalList

        solver, w1 = cr_solver()

        def signals_fn(amp):
            return [
                Signal(
                    lambda t: amp * 0.02 * np.exp(-((t - 5.0) ** 2) / 8.0),
                    carrier_freq=w1,
                )
            ]

        def sal(p):
            return SignalList(list(solver._rwa_signal_map(signals_fn(p))))

        return solver, signals_fn, sal

    def test_extraction_and_reconstruction(self):
        from qiskit_dynamics_tpu.solvers import fused_sweep as fs

        solver, _, sal = self._gauss_setup()
        k = solver.model.operators.shape[0]
        gt = np.linspace(0.0, 10.0, 40).reshape(20, 2)
        amps = np.linspace(0.25, 1.0, 10)
        fac = fs._rank1_envelope_factors(sal, amps, gt, k, 10)
        assert fac is not None
        A, P = fac
        assert A.shape[0] == k and A.shape[2] == 10
        assert P.shape == gt.shape + (k, A.shape[1])
        direct = fs._sample_coefficients_f64(sal, amps, gt, k, 10)
        rec = np.real(np.einsum("tnkr,krb->tnkb", P, A))
        assert np.max(np.abs(rec - direct)) < 1e-13

    def test_solve_matches_full_table(self):
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve
        from qiskit_dynamics_tpu.solvers import fused_sweep as fs

        solver, signals_fn, _ = self._gauss_setup()
        y0 = np.zeros(16, dtype=complex)
        y0[0] = 1.0
        amps = np.linspace(0.25, 1.0, 8)
        kw = dict(
            t_span=(0.0, 10.0), max_dt=0.2, y0=y0,
            rwa_signal_map=solver._rwa_signal_map, precision="df32",
        )
        out_r1 = fused_sweep_solve(solver.model, signals_fn, amps, **kw)
        orig1, orig2 = fs._constant_envelope_factors, fs._rank1_envelope_factors
        fs._constant_envelope_factors = lambda *a, **k: None
        fs._rank1_envelope_factors = lambda *a, **k: None
        try:
            out_full = fused_sweep_solve(solver.model, signals_fn, amps, **kw)
        finally:
            fs._constant_envelope_factors = orig1
            fs._rank1_envelope_factors = orig2
        assert np.max(np.abs(out_r1 - out_full)) < 1e-11

    def test_width_sweep_rejected(self):
        # a pulse-WIDTH sweep changes the shape itself: not rank-1
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.signals import SignalList
        from qiskit_dynamics_tpu.solvers import fused_sweep as fs

        solver, w1 = cr_solver()

        def sal(sig):
            return SignalList(
                list(
                    solver._rwa_signal_map(
                        [
                            Signal(
                                lambda t: 0.02 * np.exp(-((t - 5.0) ** 2) / (2 * sig**2)),
                                carrier_freq=w1,
                            )
                        ]
                    )
                )
            )

        gt = np.linspace(0.0, 10.0, 40).reshape(20, 2)
        k = solver.model.operators.shape[0]
        assert (
            fs._rank1_envelope_factors(sal, np.linspace(1.0, 3.0, 10), gt, k, 10)
            is None
        )

    def test_phase_sweep_factorizes(self):
        # per-member PHASE of a fixed shape: complex rank-1 scales; also
        # exercises the (r, B) term-major phase layout of RWA SignalSums
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.signals import SignalList
        from qiskit_dynamics_tpu.solvers import fused_sweep as fs

        solver, w1 = cr_solver()

        def sal(ph):
            return SignalList(
                list(
                    solver._rwa_signal_map(
                        [
                            Signal(
                                lambda t: 0.02 * np.exp(-((t - 5.0) ** 2) / 8.0),
                                carrier_freq=w1,
                                phase=ph,
                            )
                        ]
                    )
                )
            )

        gt = np.linspace(0.0, 10.0, 40).reshape(20, 2)
        k = solver.model.operators.shape[0]
        phs = np.linspace(0.0, 1.5, 10)
        fac = fs._rank1_envelope_factors(sal, phs, gt, k, 10)
        assert fac is not None
        direct = fs._sample_coefficients_f64(sal, phs, gt, k, 10)
        rec = np.real(np.einsum("tnkr,krb->tnkb", fac[1], fac[0]))
        assert np.max(np.abs(rec - direct)) < 1e-13

    def test_profile_validation(self):
        from qiskit_dynamics_tpu.ops.df_sweep import sweep_expm_magnus_df

        n, k, B = 2, 1, 3
        static = np.zeros((n, n), dtype=complex)
        ops = np.zeros((k, n, n), dtype=complex)
        omega = np.zeros((n, n))
        y0 = np.ones((n, B), dtype=complex)
        A = np.ones((k, 1, B), dtype=complex)
        dts = np.full(4, 0.1)
        bad_profile = np.ones((4, 3, k, 2), dtype=complex)  # R mismatch
        with pytest.raises(ValueError, match="profile"):
            sweep_expm_magnus_df(
                static, ops, omega, None, y0, dt=dts,
                coef_factors=(A, bad_profile),
            )

    def test_engine_profile_path_matches_full(self):
        # direct engine check: coef_factors=(A, P) == the same table passed
        # densely (df roundoff)
        from qiskit_dynamics_tpu.ops.df_sweep import sweep_expm_magnus_df, MAGNUS_NODES

        rng = np.random.default_rng(7)
        n, k, B, T = 4, 2, 5, 12
        h = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
        static = -1j * (h + h.conj().T) * 0.1
        opmats = []
        for _ in range(k):
            hj = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
            opmats.append(-1j * (hj + hj.conj().T) * 0.1)
        ops = np.array(opmats)
        w = rng.normal(size=n)
        omega = w[None, :] - w[:, None]
        y0 = rng.normal(size=(n, B)) + 1j * rng.normal(size=(n, B))
        y0 = y0 / np.linalg.norm(y0, axis=0)
        dts = np.full(T, 0.1)
        nodes = MAGNUS_NODES[3]
        t_start = np.concatenate([[0.0], np.cumsum(dts)[:-1]])
        tau = t_start[:, None] + dts[:, None] * nodes[None, :]
        # rank-2 profiles + complex member scales
        P = np.exp(2j * np.pi * rng.normal(size=(1, 1, k, 2)) * tau[:, :, None, None]) * (
            1.0 + 0.3 * np.sin(tau)[:, :, None, None]
        )
        A = (rng.normal(size=(k, 2, B)) + 1j * rng.normal(size=(k, 2, B))) * 0.2
        table = np.real(np.einsum("tnkr,krb->tnkb", P, A))
        out_fac = sweep_expm_magnus_df(
            static, ops, omega, None, y0, dt=dts, magnus_order=3,
            coef_factors=(A, P), chunk_b=4,
        )
        out_full = sweep_expm_magnus_df(
            static, ops, omega, table, y0, dt=dts, magnus_order=3, chunk_b=4
        )
        assert np.max(np.abs(out_fac - out_full)) < 1e-10


class TestEchoEnvelopeDetection:
    """Review hardening: envelopes that idle at coarse probe times but pulse
    between them (echo-style schedules) must not be mis-detected as
    constant; the rank-1 path resolves them via the reference member's FULL
    trajectory (scales at its peak time)."""

    def _echo_sal(self):
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.signals import SignalList
        from qiskit_dynamics_tpu import Signal

        solver, w1 = cr_solver()

        def sal(p):
            return SignalList(
                list(
                    solver._rwa_signal_map(
                        [
                            Signal(
                                lambda t: p
                                * 0.02
                                * np.where(np.abs(t - 5.0) < 0.5, 1.0, 0.0),
                                carrier_freq=w1,
                            )
                        ]
                    )
                )
            )

        return solver, sal

    def test_not_constant(self):
        from qiskit_dynamics_tpu.solvers import fused_sweep as fs

        solver, sal = self._echo_sal()
        k = solver.model.operators.shape[0]
        gt = np.linspace(0.0, 10.0, 100).reshape(50, 2)
        amps = np.linspace(0.25, 1.0, 6)
        assert fs._constant_envelope_factors(sal, amps, gt.ravel(), k, 6) is None

    def test_rank1_resolves_echo(self):
        from qiskit_dynamics_tpu.solvers import fused_sweep as fs

        solver, sal = self._echo_sal()
        k = solver.model.operators.shape[0]
        gt = np.linspace(0.0, 10.0, 100).reshape(50, 2)
        amps = np.linspace(0.25, 1.0, 6)
        fac = fs._rank1_envelope_factors(sal, amps, gt, k, 6)
        assert fac is not None
        direct = fs._sample_coefficients_f64(sal, amps, gt, k, 6)
        rec = np.real(np.einsum("tnkr,krb->tnkb", fac[1], fac[0]))
        assert np.max(np.abs(rec - direct)) < 1e-13

    def test_sampler_compact_rejects_member_time_dependence(self):
        # members 0 and B-1 constant, middle members time-varying: the
        # compact path must fall back to full sampling
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.signals import SignalList
        from qiskit_dynamics_tpu.solvers import fused_sweep as fs
        from qiskit_dynamics_tpu import Signal

        solver, w1 = cr_solver()
        k = solver.model.operators.shape[0]

        def sal(p):
            return SignalList(
                list(
                    solver._rwa_signal_map(
                        [
                            Signal(
                                lambda t: p * 0.02
                                + (p - 0.25) * (1.0 - p) * 0.1 * np.sin(t),
                                carrier_freq=w1,
                            )
                        ]
                    )
                )
            )

        gt = np.linspace(0.0, 10.0, 100).reshape(50, 2)
        amps = np.linspace(0.25, 1.0, 6)
        direct = fs._sample_coefficients_f64(sal, amps, gt, k, 6)
        ref = np.stack(
            [np.asarray(sal(np.array(a))(gt)) for a in amps], axis=-1
        )
        assert np.max(np.abs(direct - ref)) < 1e-12


class TestDfDevices:
    """Host-fed multi-device df32: chunk dispatches round-robin across
    ``df_devices`` with per-device invariant tables; results are
    bit-identical to the single-device call on every coefficient path."""

    @pytest.mark.parametrize(
        "name",
        ["const", "rank1", "full_table"],
    )
    def test_multi_device_matches_single(self, name):
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve
        from qiskit_dynamics_tpu import Signal

        solver, w1 = cr_solver()
        y0 = np.zeros(16, dtype=complex)
        y0[0] = 1.0
        amps = np.linspace(0.25, 1.0, 10)
        fns = {
            "const": lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)],
            "rank1": lambda a: [
                Signal(
                    lambda t: a * 0.02 * np.exp(-((t - 5.0) ** 2) / 8.0),
                    carrier_freq=w1,
                )
            ],
            # width sweep: not factorizable -> exercises full-table chunks
            "full_table": lambda a: [
                Signal(
                    lambda t: 0.02 * np.exp(-((t - 5.0) ** 2) / (2 * (1 + a) ** 2)),
                    carrier_freq=w1,
                )
            ],
        }
        kw = dict(
            t_span=(0.0, 5.0), max_dt=0.2, y0=y0,
            rwa_signal_map=solver._rwa_signal_map, precision="df32",
            df_chunk_b=4,
        )
        single = fused_sweep_solve(solver.model, fns[name], amps, **kw)
        multi = fused_sweep_solve(
            solver.model, fns[name], amps, df_devices=jax.devices(), **kw
        )
        assert np.max(np.abs(np.asarray(single) - np.asarray(multi))) == 0.0

    def test_mesh_rejected_points_at_df_devices(self):
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve
        from qiskit_dynamics_tpu.parallel import data_mesh
        from qiskit_dynamics_tpu.exceptions import DynamicsError
        from qiskit_dynamics_tpu import Signal

        solver, w1 = cr_solver()
        y0 = np.zeros(16, dtype=complex)
        y0[0] = 1.0
        with pytest.raises(DynamicsError, match="df_devices"):
            fused_sweep_solve(
                solver.model,
                lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)],
                np.linspace(0.25, 1.0, 4),
                t_span=(0.0, 2.0), max_dt=0.2, y0=y0,
                rwa_signal_map=solver._rwa_signal_map,
                precision="df32", mesh=data_mesh(),
            )


def test_rank1_with_adaptive_grid():
    """df_grid='adaptive' (non-uniform steps concentrated at the pulse) and
    the rank-1 profile factorization compose: the profile samples at the
    adaptive grid's actual Gauss times."""
    from qiskit_dynamics_tpu.benchmarks import cr_solver
    from qiskit_dynamics_tpu.solvers import fused_sweep_solve
    from qiskit_dynamics_tpu.solvers import fused_sweep as fs
    from qiskit_dynamics_tpu import Signal

    solver, w1 = cr_solver()
    y0 = np.zeros(16, dtype=complex)
    y0[0] = 1.0
    amps = np.linspace(0.25, 1.0, 6)
    fn = lambda a: [
        Signal(lambda t: a * 0.02 * np.exp(-((t - 5.0) ** 2) / 2.0), carrier_freq=w1)
    ]
    kw = dict(
        t_span=(0.0, 10.0), max_dt=0.5, y0=y0,
        rwa_signal_map=solver._rwa_signal_map, precision="df32",
        df_grid="adaptive", df_grid_tol=1e-10, df_chunk_b=4,
    )
    out = fused_sweep_solve(solver.model, fn, amps, **kw)
    o1, o2 = fs._constant_envelope_factors, fs._rank1_envelope_factors
    fs._constant_envelope_factors = lambda *a, **k: None
    fs._rank1_envelope_factors = lambda *a, **k: None
    try:
        full = fused_sweep_solve(solver.model, fn, amps, **kw)
    finally:
        fs._constant_envelope_factors, fs._rank1_envelope_factors = o1, o2
    assert np.max(np.abs(np.asarray(out) - np.asarray(full))) < 1e-12
    r = solver.solve(
        t_span=(0.0, 10.0), y0=y0, signals=fn(amps[-1]),
        method="DOP853", atol=1e-13, rtol=1e-13,
    )
    assert np.max(np.abs(out[-1] - np.asarray(r.y[-1]))) < 1e-9


def test_df32_schedule_serving():
    """Reference-grade (1e-8-class and beyond) pulse-SCHEDULE serving: a
    batch of schedules' sample tables solves through
    solve_sweep(method='fused_magnus2', precision='df32') with the step
    grid aligned to the sample cells (max_dt divides the schedule dt, so
    every Magnus step sees a smooth RHS). Measured 5e-12 vs DOP853(1e-13)
    on a Gaussian amplitude batch — the df32 answer to the f32 serving
    path's tolerance-limited accuracy."""
    from qiskit_dynamics_tpu import Solver
    from qiskit_dynamics_tpu.pulse import Schedule, Play, DriveChannel, Gaussian
    from qiskit_dynamics_tpu.signals import DiscreteSignal

    nu, r, dt = 5.0, 0.1, 0.1
    X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
    Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
    solver = Solver(
        static_hamiltonian=2 * np.pi * nu * Z / 2,
        hamiltonian_operators=[2 * np.pi * r * X / 2],
        hamiltonian_channels=["d0"],
        channel_carrier_freqs={"d0": nu},
        dt=dt,
        rotating_frame=2 * np.pi * nu * Z / 2,
    )
    y0 = np.array([1.0, 0.0], dtype=complex)
    duration, tf = 40, 4.0
    scheds = []
    for amp in np.linspace(0.2, 0.8, 4):
        s = Schedule(name=f"a{amp}")
        s.append(
            Play(Gaussian(duration=duration, amp=float(amp), sigma=8), DriveChannel(0))
        )
        scheds.append(s)
    samples = np.stack(
        [np.asarray(solver._schedule_converter.get_signals(s)[0].samples) for s in scheds]
    )

    def signals_fn(q):
        return [DiscreteSignal(dt=dt, samples=q, carrier_freq=nu)]

    out = solver.solve_sweep(
        signals_fn, samples, t_span=(0.0, tf), y0=y0,
        method="fused_magnus2", max_dt=0.005, precision="df32",
    )
    for i, s in enumerate(scheds):
        ref = solver.solve(
            t_span=[0.0, tf], y0=y0, signals=s, method="DOP853",
            atol=1e-13, rtol=1e-13, convert_results=False,
        )
        assert np.max(np.abs(out[i] - np.asarray(ref.y[-1]))) < 1e-10


def test_adaptive_grid_magnus2():
    """Regression: df_grid='adaptive' with df_magnus_order=2 used the
    Magnus-2 step rule in the host grid builder without importing its
    commutator constant (NameError)."""
    from qiskit_dynamics_tpu.benchmarks import cr_solver
    from qiskit_dynamics_tpu.solvers import fused_sweep_solve
    from qiskit_dynamics_tpu import Signal

    solver, w1 = cr_solver()
    y0 = np.zeros(16, dtype=complex)
    y0[0] = 1.0
    amps = np.linspace(0.25, 1.0, 4)
    fn = lambda a: [
        Signal(lambda t: a * 0.02 * np.exp(-((t - 5.0) ** 2) / 2.0), carrier_freq=w1)
    ]
    out = fused_sweep_solve(
        solver.model, fn, amps, t_span=(0.0, 10.0), max_dt=0.25, y0=y0,
        rwa_signal_map=solver._rwa_signal_map, precision="df32",
        df_magnus_order=2, df_grid="adaptive", df_grid_tol=1e-9, df_chunk_b=4,
    )
    r = solver.solve(
        t_span=(0.0, 10.0), y0=y0, signals=fn(amps[-1]),
        method="DOP853", atol=1e-13, rtol=1e-13,
    )
    assert np.max(np.abs(out[-1] - np.asarray(r.y[-1]))) < 1e-7


def test_df32_no_time_dependent_terms():
    """Regression: k=0 (static-only model) crashed the envelope
    factorization detectors with ValueError on the empty signal list; the
    sampling path handles the (T, nodes, 0, B) table fine."""
    from qiskit_dynamics_tpu.models import HamiltonianModel
    from qiskit_dynamics_tpu.solvers import fused_sweep_solve
    from scipy.linalg import expm

    Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
    model = HamiltonianModel(operators=[], static_operator=2 * np.pi * Z / 2)
    y0 = np.array([1.0, 0.0], dtype=complex)
    out = fused_sweep_solve(
        model, lambda a: [], np.zeros(3), t_span=(0.0, 1.0), max_dt=0.1,
        y0=y0, precision="df32", df_chunk_b=4,
    )
    ref = expm(-1j * 2 * np.pi * Z / 2) @ y0
    assert out.shape == (3, 2)
    assert np.max(np.abs(np.asarray(out) - ref[None, :])) < 1e-10


class TestDf32Trajectories:
    """t_eval trajectory output through the df32 engine (in-scan slot
    stores; host f64 collector). Parity with the f32 fixed-step path's
    on-grid contract; reference t_eval semantics at
    /root/reference/qiskit_dynamics/solvers/solver_functions.py (t_eval
    subsetting of solve output)."""

    def _cr(self):
        from qiskit_dynamics_tpu import Signal
        from qiskit_dynamics_tpu.benchmarks import cr_solver

        solver, w1 = cr_solver(dim=2)
        sig_fn = lambda a: [Signal(lambda t: a * 0.02, carrier_freq=w1)]
        return solver, sig_fn

    def test_vector_y0_trajectory_1e_8(self):
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        solver, sig_fn = self._cr()
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        amps = np.array([0.4, 0.9])
        t_eval = [0.0, 1.0, 2.0, 3.0]  # includes t0
        out = fused_sweep_solve(
            solver.model, sig_fn, amps, t_span=(0.0, 3.0), max_dt=0.05,
            y0=y0, precision="df32", t_eval=t_eval,
            rwa_signal_map=solver._rwa_signal_map, df_chunk_b=8,
        )
        assert np.asarray(out).shape == (2, 4, 4)
        assert np.asarray(out).dtype == np.complex128
        for i, a in enumerate(amps):
            ref = solver.solve(
                t_span=[0.0, 3.0], y0=y0, signals=sig_fn(float(a)),
                t_eval=t_eval, method="DOP853", atol=1e-13, rtol=1e-13,
            )
            np.testing.assert_allclose(
                np.asarray(out[i]), np.asarray(ref.y), rtol=1e-8, atol=1e-8
            )

    def test_matrix_y0_trajectory(self):
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        solver, sig_fn = self._cr()
        y0 = np.eye(4, dtype=complex)
        amps = np.array([0.4, 0.9])
        t_eval = [1.0, 3.0]  # no t0
        out = fused_sweep_solve(
            solver.model, sig_fn, amps, t_span=(0.0, 3.0), max_dt=0.1,
            y0=y0, precision="df32", t_eval=t_eval,
            rwa_signal_map=solver._rwa_signal_map, df_chunk_b=8,
        )
        assert np.asarray(out).shape == (2, 2, 4, 4)
        ref = solver.solve(
            t_span=[0.0, 3.0], y0=y0, signals=sig_fn(0.9), t_eval=t_eval,
            method="DOP853", atol=1e-13, rtol=1e-13,
        )
        np.testing.assert_allclose(
            np.asarray(out[1]), np.asarray(ref.y), rtol=1e-8, atol=1e-8
        )

    def test_vectorized_lindblad_trajectory(self):
        from qiskit_dynamics_tpu import Signal, Solver
        from qiskit_dynamics_tpu.quantum_info import DensityMatrix
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
        Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
        H0 = 2 * np.pi * 5.0 * Z / 2
        solver = Solver(
            static_hamiltonian=H0,
            hamiltonian_operators=[2 * np.pi * 0.1 * X / 2],
            static_dissipators=[0.05 * np.array([[0.0, 1.0], [0.0, 0.0]])],
            rotating_frame=H0,
            vectorized=True,
        )
        amps = np.array([0.4, 0.9])
        sig_fn = lambda a: [Signal(lambda t: a, carrier_freq=5.0)]
        rho0 = np.diag([1.0, 0.0]).astype(complex)
        t_eval = [0.5, 1.0]
        out = fused_sweep_solve(
            solver.model, sig_fn, amps, t_span=(0.0, 1.0), max_dt=0.01,
            y0=rho0, precision="df32", t_eval=t_eval, df_chunk_b=8,
        )
        assert np.asarray(out).shape == (2, 2, 2, 2)
        for i, a in enumerate(amps):
            ref = solver.solve(
                t_span=[0.0, 1.0], y0=DensityMatrix(rho0),
                signals=sig_fn(float(a)), t_eval=t_eval,
                method="DOP853", atol=1e-13, rtol=1e-13,
            )
            np.testing.assert_allclose(
                np.asarray(out[i]), np.asarray([y.data for y in ref.y]),
                rtol=1e-8, atol=1e-8,
            )

    def test_t0_only(self):
        """t_eval=[t0] returns just the (frame-converted) initial state."""
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        solver, sig_fn = self._cr()
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 0.6
        y0[2] = 0.8
        amps = np.array([0.4, 0.9])
        out = fused_sweep_solve(
            solver.model, sig_fn, amps, t_span=(0.0, 2.0), max_dt=0.1,
            y0=y0, precision="df32", t_eval=[0.0],
            rwa_signal_map=solver._rwa_signal_map, df_chunk_b=8,
        )
        assert np.asarray(out).shape == (2, 1, 4)
        np.testing.assert_allclose(np.asarray(out[0, 0]), y0, atol=1e-12)
        np.testing.assert_allclose(np.asarray(out[1, 0]), y0, atol=1e-12)

    def test_validation_errors(self):
        from qiskit_dynamics_tpu.exceptions import DynamicsError
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        solver, sig_fn = self._cr()
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        amps = np.array([0.4])

        def run(t_eval, **kw):
            return fused_sweep_solve(
                solver.model, sig_fn, amps, t_span=(0.0, 3.0), max_dt=0.1,
                y0=y0, precision="df32", t_eval=t_eval,
                rwa_signal_map=solver._rwa_signal_map, **kw,
            )

        with pytest.raises(DynamicsError, match="increasing"):
            run([1.0, 1.0])
        with pytest.raises(DynamicsError, match="within t_span"):
            run([1.0, 5.0])

    def test_off_grid_t_eval_splits_steps(self):
        """Off-grid evaluation times split the containing step exactly (the
        df32 engine takes per-step sizes), so arbitrary t_eval works —
        including points 1e-8 apart (a sliver step, computed exactly)."""
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        solver, sig_fn = self._cr()
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0
        amps = np.array([0.4, 0.9])
        t_eval = [0.437, 1.0, 2.2513]  # none on the max_dt=0.1 grid
        out = fused_sweep_solve(
            solver.model, sig_fn, amps, t_span=(0.0, 3.0), max_dt=0.1,
            y0=y0, precision="df32", t_eval=t_eval,
            rwa_signal_map=solver._rwa_signal_map, df_chunk_b=8,
        )
        assert np.asarray(out).shape == (2, 3, 4)
        for i, a in enumerate(amps):
            ref = solver.solve(
                t_span=[0.0, 3.0], y0=y0, signals=sig_fn(float(a)),
                t_eval=t_eval, method="DOP853", atol=1e-13, rtol=1e-13,
            )
            np.testing.assert_allclose(
                np.asarray(out[i]), np.asarray(ref.y), rtol=1e-8, atol=1e-8
            )
