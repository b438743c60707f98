"""Tests for DysonSolver / MagnusSolver against adaptive-solver ground truth."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qiskit_dynamics_tpu import Signal, solve_ode, DysonSolver, MagnusSolver
from qiskit_dynamics_tpu.exceptions import DynamicsError

X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)

NU = 5.0
G0 = -1j * 2 * np.pi * NU * Z / 2
G1 = -1j * 2 * np.pi * X / 2


def _ground_truth(envelope, T):
    """Solution in the rotating frame of G0 (perturbative solvers solve the
    LMDE with the toggling-frame generator; see reference DysonSolver doc)."""
    from scipy.linalg import expm

    def rhs(t, y):
        sig = np.real(envelope(t) * np.exp(1j * 2 * np.pi * NU * t))
        return (G0 + sig * G1) @ y

    res = solve_ode(rhs, [0.0, T], np.eye(2, dtype=complex), method="DOP853",
                    atol=1e-13, rtol=1e-13)
    return expm(-T * G0) @ np.asarray(res.y[-1])


def _gauss(amp, sigma, T):
    def env(t):
        return amp * np.exp(-((t - T / 2) ** 2) / (2 * sigma**2))
    return env


@pytest.fixture(scope="module")
def dyson_solver():
    return DysonSolver(
        operators=[G1],
        rotating_frame=G0,
        dt=0.025,
        carrier_freqs=[NU],
        chebyshev_orders=[2],
        expansion_order=5,
        atol=1e-13, rtol=1e-13,
    )


@pytest.fixture(scope="module")
def magnus_solver():
    return MagnusSolver(
        operators=[G1],
        rotating_frame=G0,
        dt=0.025,
        carrier_freqs=[NU],
        chebyshev_orders=[2],
        expansion_order=3,
        atol=1e-13, rtol=1e-13,
    )


class TestDysonSolver:
    def test_vs_ground_truth(self, dyson_solver):
        T, n_steps = 1.0, 40
        env = _gauss(0.4, 0.25, T)
        sig = Signal(env, carrier_freq=NU)
        res = dyson_solver.solve(t0=0.0, n_steps=n_steps, y0=np.eye(2, dtype=complex),
                                 signals=[sig])
        expected = _ground_truth(env, T)
        err = np.max(np.abs(np.asarray(res.y[-1]) - expected))
        assert err < 1e-6, err

    def test_jax_path_matches_numpy(self, dyson_solver):
        T, n_steps = 0.5, 20
        env = _gauss(0.3, 0.2, T)
        sig = Signal(env, carrier_freq=NU)
        y0 = np.eye(2, dtype=complex)
        res_np = dyson_solver.solve(0.0, n_steps, y0, [sig], jax_control_flow=False)
        res_jax = dyson_solver.solve(0.0, n_steps, jnp.asarray(y0), [sig])
        np.testing.assert_allclose(
            np.asarray(res_jax.y[-1]), np.asarray(res_np.y[-1]), atol=1e-10
        )

    def test_jit_grad_through_solve(self, dyson_solver):
        n_steps = 10

        @jax.jit
        def overlap(amp):
            sig = Signal(lambda t: amp * jnp.exp(-((t - 0.125) ** 2) / 0.02),
                         carrier_freq=NU)
            res = dyson_solver.solve(0.0, n_steps, jnp.eye(2, dtype=complex), [sig])
            return jnp.abs(res.y[-1][1, 0]) ** 2

        v = overlap(0.5)
        g = jax.grad(lambda a: overlap(a).real)(0.5)
        assert np.isfinite(float(v)) and np.isfinite(float(g))

    def test_list_broadcast(self, dyson_solver):
        sig1 = Signal(_gauss(0.3, 0.2, 0.5), carrier_freq=NU)
        sig2 = Signal(_gauss(0.5, 0.2, 0.5), carrier_freq=NU)
        results = dyson_solver.solve(
            0.0, 10, np.eye(2, dtype=complex), [[sig1], [sig2]]
        )
        assert isinstance(results, list) and len(results) == 2

    def test_signal_length_validation(self, dyson_solver):
        with pytest.raises(DynamicsError):
            dyson_solver.solve(0.0, 5, np.eye(2, dtype=complex),
                               [Signal(1.0, NU), Signal(1.0, NU)])


class TestMagnusSolver:
    def test_vs_ground_truth(self, magnus_solver):
        T, n_steps = 1.0, 40
        env = _gauss(0.4, 0.25, T)
        sig = Signal(env, carrier_freq=NU)
        res = magnus_solver.solve(t0=0.0, n_steps=n_steps, y0=np.eye(2, dtype=complex),
                                  signals=[sig])
        expected = _ground_truth(env, T)
        err = np.max(np.abs(np.asarray(res.y[-1]) - expected))
        assert err < 1e-6, err

    def test_jax_path_matches_numpy(self, magnus_solver):
        T, n_steps = 0.5, 20
        env = _gauss(0.3, 0.2, T)
        sig = Signal(env, carrier_freq=NU)
        y0 = np.eye(2, dtype=complex)
        res_np = magnus_solver.solve(0.0, n_steps, y0, [sig], jax_control_flow=False)
        res_jax = magnus_solver.solve(0.0, n_steps, jnp.asarray(y0), [sig])
        np.testing.assert_allclose(
            np.asarray(res_jax.y[-1]), np.asarray(res_np.y[-1]), atol=1e-10
        )


class TestExpansionModelValidation:
    def test_bad_method(self):
        from qiskit_dynamics_tpu.solvers import ExpansionModel

        with pytest.raises(DynamicsError):
            ExpansionModel(
                operators=[G1], rotating_frame=G0, dt=0.1, carrier_freqs=[NU],
                chebyshev_orders=[1], expansion_method="taylor", expansion_order=2,
            )

    def test_length_mismatch(self):
        from qiskit_dynamics_tpu.solvers import ExpansionModel

        with pytest.raises(DynamicsError):
            ExpansionModel(
                operators=[G1], rotating_frame=G0, dt=0.1, carrier_freqs=[NU, NU],
                chebyshev_orders=[1], expansion_order=2,
            )


def test_solve_sweep_matches_per_member(dyson_solver):
    """Batched chain-scan sweep == per-member solves."""
    y0 = np.array([1.0, 0.0], dtype=complex)
    amps = jnp.array([0.2, 0.4])
    n_steps = 10
    signals_fn = lambda a: [
        Signal(lambda t: a * jnp.exp(-((t - 0.125) ** 2) / 0.02), carrier_freq=NU)
    ]
    out = dyson_solver.solve_sweep(0.0, n_steps, y0, signals_fn, amps)
    for i, a in enumerate([0.2, 0.4]):
        sig = Signal(lambda t, a=a: a * np.exp(-((t - 0.125) ** 2) / 0.02),
                     carrier_freq=NU)
        ref = dyson_solver.solve(0.0, n_steps, y0, [sig], jax_control_flow=False)
        np.testing.assert_allclose(
            np.asarray(out[i]), np.asarray(ref.y[-1]), atol=1e-10
        )


def test_solve_sweep_magnus_matches_per_member(magnus_solver):
    """Magnus batched sweep (batched expm + chain scan) == per-member solves."""
    y0 = np.array([1.0, 0.0], dtype=complex)
    amps = jnp.array([0.2, 0.4])
    n_steps = 10
    signals_fn = lambda a: [
        Signal(lambda t: a * jnp.exp(-((t - 0.125) ** 2) / 0.02), carrier_freq=NU)
    ]
    out = magnus_solver.solve_sweep(0.0, n_steps, y0, signals_fn, amps)
    for i, a in enumerate([0.2, 0.4]):
        sig = Signal(lambda t, a=a: a * np.exp(-((t - 0.125) ** 2) / 0.02),
                     carrier_freq=NU)
        ref = magnus_solver.solve(0.0, n_steps, y0, [sig], jax_control_flow=False)
        np.testing.assert_allclose(
            np.asarray(out[i]), np.asarray(ref.y[-1]), atol=1e-9
        )


def test_solve_sweep_magnus_grad(magnus_solver):
    """jax.grad through MagnusSolver.solve_sweep (plain autodiff through the
    batched Taylor expm and the chain scan) against finite differences."""
    y0 = np.array([1.0, 0.0], dtype=complex)
    n_steps = 10
    signals_fn = lambda a: [
        Signal(lambda t: a * jnp.exp(-((t - 0.125) ** 2) / 0.02), carrier_freq=NU)
    ]

    def loss(amp):
        out = magnus_solver.solve_sweep(
            0.0, n_steps, y0, signals_fn, jnp.array([amp, 0.5 * amp]),
        )
        return jnp.sum(jnp.abs(out[:, 1]) ** 2)

    g = float(jax.grad(loss)(0.3))
    eps = 1e-5
    fd = (float(loss(0.3 + eps)) - float(loss(0.3 - eps))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-5)


def test_solve_sweep_mesh_matches_serial(dyson_solver):
    """solve_sweep(mesh=...) shards the batch over the 8-device mesh and
    matches the serial call exactly (pad-to-8 trimming exercised at B=6)."""
    from qiskit_dynamics_tpu.parallel import data_mesh

    y0 = np.array([1.0, 0.0], dtype=complex)
    amps = jnp.linspace(0.1, 0.6, 6)
    n_steps = 10
    signals_fn = lambda a: [
        Signal(lambda t: a * jnp.exp(-((t - 0.125) ** 2) / 0.02), carrier_freq=NU)
    ]
    serial = dyson_solver.solve_sweep(0.0, n_steps, y0, signals_fn, amps)
    sharded = dyson_solver.solve_sweep(
        0.0, n_steps, y0, signals_fn, amps, mesh=data_mesh()
    )
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(serial), atol=1e-13
    )


# ---------------------------------------------------------------------------
# 2-qubit configurations (ref: test_dyson_solver_2q / _2q_0_carrier /
# test_magnus_solver_2q in /root/reference/test/dynamics/solvers/
# test_dyson_magnus_solvers.py) — behaviors re-derived against DOP853
# ground truth, including a 0-carrier-frequency static-coupling channel
# and the include_imag reduction for real envelopes.
# ---------------------------------------------------------------------------

I2 = np.eye(2, dtype=complex)
NU_B = 4.6
G0_2Q = -1j * 2 * np.pi * (NU * np.kron(Z, I2) + NU_B * np.kron(I2, Z)) / 2
GA_2Q = -1j * 2 * np.pi * np.kron(X, I2) / 2
GB_2Q = -1j * 2 * np.pi * 0.1 * np.kron(Z, X) / 2


def _ground_truth_multi(g0, ops, signals, T):
    """Frame-of-g0 solution for sum_j Re[s_j(t)] ops[j], via DOP853."""
    from scipy.linalg import expm

    def rhs(t, y):
        g = np.asarray(g0, dtype=complex).copy()
        for s, op in zip(signals, ops):
            g = g + float(np.real(s(t))) * op
        return g @ y

    res = solve_ode(rhs, [0.0, T], np.eye(g0.shape[0], dtype=complex),
                    method="DOP853", atol=1e-13, rtol=1e-13)
    return expm(-T * np.asarray(g0)) @ np.asarray(res.y[-1])


class Test2QubitPerturbative:
    @pytest.fixture(scope="class")
    def solver_2q(self):
        return DysonSolver(
            operators=[GA_2Q, GB_2Q],
            rotating_frame=G0_2Q,
            dt=0.02,
            carrier_freqs=[NU, NU_B],
            chebyshev_orders=[1, 1],
            expansion_order=4,
            atol=1e-13, rtol=1e-13,
        )

    def test_dyson_2q_vs_ground_truth(self, solver_2q):
        T, n_steps = 0.5, 25
        env_a = _gauss(0.4, 0.15, T)
        env_b = _gauss(0.2, 0.2, T)
        sigs = [Signal(env_a, carrier_freq=NU), Signal(env_b, carrier_freq=NU_B)]
        res = solver_2q.solve(0.0, n_steps, np.eye(4, dtype=complex), sigs)
        expected = _ground_truth_multi(G0_2Q, [GA_2Q, GB_2Q], sigs, T)
        err = np.max(np.abs(np.asarray(res.y[-1]) - expected))
        assert err < 1e-4, err

    def test_magnus_2q_vs_ground_truth(self):
        solver = MagnusSolver(
            operators=[GA_2Q, GB_2Q],
            rotating_frame=G0_2Q,
            dt=0.02,
            carrier_freqs=[NU, NU_B],
            chebyshev_orders=[1, 1],
            expansion_order=3,
            atol=1e-13, rtol=1e-13,
        )
        T, n_steps = 0.3, 15
        env_a = _gauss(0.4, 0.15, T)
        env_b = _gauss(0.2, 0.2, T)
        sigs = [Signal(env_a, carrier_freq=NU), Signal(env_b, carrier_freq=NU_B)]
        res = solver.solve(0.0, n_steps, np.eye(4, dtype=complex), sigs)
        expected = _ground_truth_multi(G0_2Q, [GA_2Q, GB_2Q], sigs, T)
        err = np.max(np.abs(np.asarray(res.y[-1]) - expected))
        assert err < 1e-4, err

    def test_dyson_2q_zero_carrier(self):
        """A 0-carrier channel (always-on coupling with a slow envelope)."""
        solver = DysonSolver(
            operators=[GA_2Q, GB_2Q],
            rotating_frame=G0_2Q,
            dt=0.02,
            carrier_freqs=[NU, 0.0],
            chebyshev_orders=[1, 1],
            expansion_order=4,
            atol=1e-13, rtol=1e-13,
        )
        T, n_steps = 0.5, 25
        env_a = _gauss(0.4, 0.15, T)
        sigs = [Signal(env_a, carrier_freq=NU), Signal(0.3, carrier_freq=0.0)]
        res = solver.solve(0.0, n_steps, np.eye(4, dtype=complex), sigs)
        expected = _ground_truth_multi(G0_2Q, [GA_2Q, GB_2Q], sigs, T)
        err = np.max(np.abs(np.asarray(res.y[-1]) - expected))
        assert err < 1e-4, err


class TestIncludeImag:
    def test_real_envelope_matches_default(self):
        """include_imag=[False] drops the sin-quadrature perturbations. The
        shifted-envelope DCT coefficients carry a per-interval carrier
        realignment phase e^{i 2 pi nu t_k}, so they are real exactly when
        the envelope is real AND nu * dt is an integer — in that regime the
        reduced solver must match the default one exactly (the dropped
        terms' coefficients are identically zero)."""
        kwargs = dict(
            operators=[G1],
            rotating_frame=G0,
            dt=0.2,  # NU * dt = 1.0: realignment phase is unity
            carrier_freqs=[NU],
            chebyshev_orders=[2],
            expansion_order=4,
            atol=1e-13, rtol=1e-13,
        )
        s_full = DysonSolver(**kwargs)
        s_real = DysonSolver(include_imag=[False], **kwargs)
        assert len(s_real.model.expansion_polynomial.monomial_labels) < len(
            s_full.model.expansion_polynomial.monomial_labels
        )
        T, n_steps = 1.0, 5
        env = _gauss(0.4, 0.2, T)
        sig = Signal(env, carrier_freq=NU)
        y0 = np.eye(2, dtype=complex)
        r_full = s_full.solve(0.0, n_steps, y0, [sig])
        r_real = s_real.solve(0.0, n_steps, y0, [sig])
        np.testing.assert_allclose(
            np.asarray(r_real.y[-1]), np.asarray(r_full.y[-1]), atol=1e-8
        )


# ---------------------------------------------------------------------------
# precision="df32": the perturbative solvers' 1e-8 mode (ops/df_chain.py).
# Against full-f64 host stepping of the SAME polynomial the only difference
# is arithmetic (df32 ~2^-48 + the f32 tail of order>df_order terms), so
# agreement at ~1e-12 proves the whole pipeline (host-f64 coefficients,
# rank-1 DCT factorization, df chain) end to end.


def _df_sigs_np(a):
    return [
        Signal(lambda t: a * np.exp(-((t - 0.125) ** 2) / 0.02), carrier_freq=NU)
    ]


def test_solve_sweep_df32_dyson(dyson_solver):
    y0 = np.array([1.0, 0.0], dtype=complex)
    amps = np.linspace(0.2, 0.5, 4)
    n_steps = 10
    out = dyson_solver.solve_sweep(
        0.0, n_steps, y0, _df_sigs_np, amps, precision="df32"
    )
    assert out.dtype == np.complex128
    for i, a in enumerate(amps):
        ref = dyson_solver.solve(
            0.0, n_steps, y0, _df_sigs_np(float(a)), jax_control_flow=False
        )
        np.testing.assert_allclose(out[i], np.asarray(ref.y[-1]), atol=1e-11)


def test_solve_sweep_df32_fallback_matches_rank1(dyson_solver):
    """A signals_fn that rejects batched construction forces the per-member
    host-table fallback; results must match the rank-1 fast path to df
    roundoff."""
    y0 = np.array([1.0, 0.0], dtype=complex)
    amps = np.linspace(0.2, 0.5, 4)

    def scalar_only(a):
        if np.ndim(a) != 0:
            raise TypeError("scalar only")
        return _df_sigs_np(float(a))

    out_rank1 = dyson_solver.solve_sweep(
        0.0, 10, y0, _df_sigs_np, amps, precision="df32"
    )
    out_fb = dyson_solver.solve_sweep(
        0.0, 10, y0, scalar_only, amps, precision="df32"
    )
    np.testing.assert_allclose(out_fb, out_rank1, atol=1e-12)


def test_solve_sweep_df32_magnus(magnus_solver):
    y0 = np.array([1.0, 0.0], dtype=complex)
    amps = np.linspace(0.2, 0.5, 3)
    n_steps = 10
    out = magnus_solver.solve_sweep(
        0.0, n_steps, y0, _df_sigs_np, amps, precision="df32"
    )
    for i, a in enumerate(amps):
        ref = magnus_solver.solve(
            0.0, n_steps, y0, _df_sigs_np(float(a)), jax_control_flow=False
        )
        np.testing.assert_allclose(out[i], np.asarray(ref.y[-1]), atol=1e-11)


def test_solve_sweep_df32_validation(dyson_solver):
    y0 = np.array([1.0, 0.0], dtype=complex)
    with pytest.raises(DynamicsError, match="precision"):
        dyson_solver.solve_sweep(
            0.0, 4, y0, _df_sigs_np, np.array([0.2]), precision="f16"
        )


def test_solve_sweep_df32_device_round_robin(dyson_solver):
    """df_devices= round-robin chunk dispatch is bit-identical to the
    single-device path (pure scheduling, per-device invariant tables)."""
    y0 = np.array([1.0, 0.0], dtype=complex)
    amps = np.linspace(0.2, 0.5, 6)
    kw = dict(precision="df32", df_chunk_b=2)
    single = dyson_solver.solve_sweep(0.0, 6, y0, _df_sigs_np, amps, **kw)
    multi = dyson_solver.solve_sweep(
        0.0, 6, y0, _df_sigs_np, amps, df_devices=jax.devices(), **kw
    )
    np.testing.assert_array_equal(multi, single)
