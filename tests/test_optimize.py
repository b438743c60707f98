"""Optimal-control API (solvers/optimize.py): fidelity objectives and the
compiled multi-start GRAPE driver, checked against the analytic pi-pulse."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from qiskit_dynamics_tpu import Solver, Signal
from qiskit_dynamics_tpu.exceptions import DynamicsError
from qiskit_dynamics_tpu.solvers import (
    optimize_controls,
    state_infidelity,
    unitary_infidelity,
)

X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)


class TestObjectives:
    def test_state_infidelity_identities(self):
        y = np.array([1.0, 0.0], dtype=complex)
        assert float(state_infidelity(y, y)) == pytest.approx(0.0, abs=1e-12)
        # global phase invariance
        assert float(state_infidelity(np.exp(0.3j) * y, y)) == pytest.approx(
            0.0, abs=1e-12
        )
        orth = np.array([0.0, 1.0], dtype=complex)
        assert float(state_infidelity(y, orth)) == pytest.approx(1.0, abs=1e-12)

    def test_state_infidelity_jit_iota_target(self):
        """Regression: jitting with a closed-over complex [0, 1] target used
        to abort the process — XLA:CPU's algebraic simplifier canonicalizes
        the constant to a complex iota and miscompiles abs(iota)
        (RET_CHECK in algebraic_simplifier.cc). state_infidelity now
        computes magnitudes via real/imag split (adaptive._cabs)."""
        target = np.array([0.0, 1.0], dtype=complex)  # iota-shaped constant

        @jax.jit
        def infid(y):
            return state_infidelity(y, target)

        assert float(infid(jnp.array([0.0, 1.0], dtype=complex))) == pytest.approx(
            0.0, abs=1e-12
        )
        assert float(infid(jnp.array([1.0, 0.0], dtype=complex))) == pytest.approx(
            1.0, abs=1e-12
        )

    def test_state_infidelity_normalization_and_batch(self):
        y = np.array([[2.0, 0.0], [0.0, 3.0]], dtype=complex)  # unnormalized batch
        t = np.array([1.0, 0.0], dtype=complex)
        out = np.asarray(state_infidelity(y, t))
        np.testing.assert_allclose(out, [0.0, 1.0], atol=1e-12)
        # without normalization the |2,0> state overlaps 4x
        raw = np.asarray(state_infidelity(y, t, normalize=False))
        np.testing.assert_allclose(raw, [1.0 - 4.0, 1.0], atol=1e-12)

    def test_unitary_infidelity_identities(self):
        U = (X + Z) / np.sqrt(2)  # Hadamard
        assert float(unitary_infidelity(U, U)) == pytest.approx(0.0, abs=1e-12)
        assert float(unitary_infidelity(np.exp(1.2j) * U, U)) == pytest.approx(
            0.0, abs=1e-12
        )
        assert float(unitary_infidelity(np.eye(2), X)) == pytest.approx(
            1.0, abs=1e-12
        )
        # batch axis
        batch = np.stack([U, np.eye(2)])
        out = np.asarray(unitary_infidelity(batch, U))
        assert out.shape == (2,)
        assert out[0] == pytest.approx(0.0, abs=1e-12)

    def test_unitary_infidelity_subspace(self):
        # dim-3 propagator acting as X on the qubit block, arbitrary on |2>
        U = np.eye(3, dtype=complex)
        U[:2, :2] = X
        U[2, 2] = np.exp(0.7j)
        assert float(unitary_infidelity(U, X, subspace_dim=2)) == pytest.approx(
            0.0, abs=1e-12
        )
        # leakage out of the subspace costs fidelity
        U2 = np.zeros((3, 3), dtype=complex)
        U2[2, 0] = 1.0  # |0> -> |2|
        U2[:2, 1] = X[:2, 0]
        assert float(unitary_infidelity(U2, X, subspace_dim=2)) > 0.5


def _quadratic_loss(target):
    return lambda p: jnp.sum((p - target) ** 2)


class TestOptimizeControls:
    def test_quadratic_single_start(self):
        res = optimize_controls(
            _quadratic_loss(jnp.array([1.0, -2.0])),
            np.zeros(2),
            optimizer=optax.adam(0.2),
            steps=300,
        )
        np.testing.assert_allclose(np.asarray(res.params), [1.0, -2.0], atol=1e-3)
        assert float(res.loss) < 1e-6
        assert res.best_index is None
        assert res.loss_history.shape == (300,)
        # history decreases overall
        assert float(res.loss_history[-1]) < float(res.loss_history[0])
        # best_params property passthrough
        np.testing.assert_allclose(
            np.asarray(res.best_params), np.asarray(res.params)
        )

    def test_best_seen_tracking_beats_final(self):
        # sgd(1.2) on (p-1)^2 DIVERGES (iterate factor 1 - 2*1.2 = -1.4);
        # the best-seen iterate is the initial point, not the final one
        loss = _quadratic_loss(jnp.array([1.0]))
        res = optimize_controls(
            loss, np.zeros(1), optimizer=optax.sgd(1.2), steps=20
        )
        assert float(res.loss) == pytest.approx(1.0, abs=1e-12)  # loss at p0
        np.testing.assert_allclose(np.asarray(res.params), [0.0], atol=1e-12)
        assert float(loss(res.params_final)) > 10.0  # diverged
        assert float(res.loss) == pytest.approx(float(loss(res.params)), abs=1e-12)

    def test_final_iterate_scored(self):
        # a single large exact-Newton-like step lands the optimum ON the
        # final iterate; best-seen must include it (post-scan evaluation)
        loss = _quadratic_loss(jnp.array([1.0]))
        res = optimize_controls(
            loss, np.zeros(1), optimizer=optax.sgd(0.5), steps=1
        )
        # p1 = 0 - 0.5 * (-2) = 1.0 exactly, produced by the only step
        np.testing.assert_allclose(np.asarray(res.params), [1.0], atol=1e-12)
        assert float(res.loss) == pytest.approx(0.0, abs=1e-12)

    def test_multi_start_selects_best_basin(self):
        # double well: f(p) = (p^2 - 1)^2 + 0.5*p -> global min near p=-1
        def loss(p):
            return jnp.sum((p**2 - 1.0) ** 2 + 0.5 * p)

        p0 = np.array([[0.9], [-0.9]])  # one restart per basin
        res = optimize_controls(
            loss, p0, optimizer=optax.adam(0.05), steps=200, multi_start=True
        )
        assert res.loss.shape == (2,)
        assert res.loss_history.shape == (200, 2)
        assert res.best_index == 1
        assert float(res.best_params[0]) == pytest.approx(-1.057, abs=0.02)
        # the other restart converged to the local (worse) minimum
        assert float(res.params[0][0]) == pytest.approx(0.93, abs=0.05)
        assert float(res.best_loss) < float(res.loss[0])

    def test_multi_start_matches_independent_runs(self):
        # elementwise optimizer => stacked run identical to separate runs
        loss = lambda p: jnp.sum((p - jnp.array([2.0, -1.0])) ** 2) + jnp.sum(
            p[0] * p[1]
        )
        p0 = np.array([[0.0, 0.0], [1.0, 1.0], [-1.0, 2.0]])
        stacked = optimize_controls(
            loss, p0, optimizer=optax.adam(0.1), steps=60, multi_start=True
        )
        for r in range(3):
            single = optimize_controls(
                loss, p0[r], optimizer=optax.adam(0.1), steps=60
            )
            np.testing.assert_allclose(
                np.asarray(stacked.params[r]), np.asarray(single.params), atol=1e-6
            )
            np.testing.assert_allclose(
                np.asarray(stacked.loss_history[:, r]),
                np.asarray(single.loss_history),
                atol=1e-6,
            )

    def test_loss_aux(self):
        def loss(p):
            val = jnp.sum(p**2)
            return val, {"debug": p}

        res = optimize_controls(
            loss, np.array([3.0]), steps=100, loss_aux=True
        )
        assert float(res.loss) < 1e-3

    def test_complex_params_cross_boundary(self):
        # cjit boundary: complex parameters cross host/device as real/imag
        # pairs
        target = jnp.array([1.0 + 2.0j, -0.5j])

        def loss(p):
            return jnp.sum(jnp.abs(p - target) ** 2)

        res = optimize_controls(
            loss, np.zeros(2, dtype=complex), optimizer=optax.adam(0.3), steps=200
        )
        np.testing.assert_allclose(np.asarray(res.params), np.asarray(target), atol=1e-2)

    def test_validation_errors(self):
        with pytest.raises(DynamicsError, match="steps"):
            optimize_controls(lambda p: jnp.sum(p), np.zeros(2), steps=0)
        with pytest.raises(DynamicsError, match="restart"):
            optimize_controls(
                lambda p: jnp.sum(p["a"]) + jnp.sum(p["b"]),
                {"a": np.zeros((2, 3)), "b": np.zeros((4, 3))},
                multi_start=True,
            )
        with pytest.raises(DynamicsError, match="restart"):
            optimize_controls(
                lambda p: p**2, np.float64(1.0), multi_start=True
            )


class TestPulseOptimization:
    """End-to-end: calibrate a pi pulse through the differentiable solver."""

    def _solver(self, nu=5.0, r=0.1):
        return Solver(
            static_hamiltonian=2 * np.pi * nu * Z / 2,
            hamiltonian_operators=[2 * np.pi * r * X / 2],
            rotating_frame=2 * np.pi * nu * Z / 2,
        ), nu, r

    def test_pi_pulse_calibration(self):
        solver, nu, r = self._solver()
        T, sigma = 8.0, 2.0
        y0 = np.array([1.0, 0.0], dtype=complex)
        target = np.array([0.0, 1.0], dtype=complex)

        def loss(amp):
            env = lambda t: amp * jnp.exp(-((t - T / 2) ** 2) / (2 * sigma**2))
            res = solver.solve(
                t_span=[0.0, T], y0=y0, signals=[Signal(env, carrier_freq=nu)],
                method="tpu_dopri5", atol=1e-8, rtol=1e-8,
            )
            return state_infidelity(res.y[-1], target)

        res = optimize_controls(
            loss, 1.0, optimizer=optax.adam(0.15), steps=60
        )
        assert float(res.loss) < 1e-3
        # analytic: r * integral(envelope) = 1 for a pi rotation
        integral = float(res.params) * sigma * np.sqrt(2 * np.pi) * r
        assert abs(integral - 1.0) < 0.1

    def test_multi_start_pi_pulse(self):
        # three restarts, one seeded in a bad basin (negative amplitude of
        # the wrong scale); the driver returns the good basin as best
        solver, nu, r = self._solver()
        T, sigma = 8.0, 2.0
        y0 = np.array([1.0, 0.0], dtype=complex)
        target = np.array([0.0, 1.0], dtype=complex)

        def loss(amp):
            env = lambda t: amp * jnp.exp(-((t - T / 2) ** 2) / (2 * sigma**2))
            res = solver.solve(
                t_span=[0.0, T], y0=y0, signals=[Signal(env, carrier_freq=nu)],
                method="tpu_dopri5", atol=1e-8, rtol=1e-8,
            )
            return state_infidelity(res.y[-1], target)

        res = optimize_controls(
            loss,
            np.array([0.02, 1.2, 3.9]),
            optimizer=optax.adam(0.15),
            steps=60,
            multi_start=True,
        )
        assert float(res.best_loss) < 1e-3
        integral = float(res.best_params) * sigma * np.sqrt(2 * np.pi) * r
        # pi rotation (odd multiples also solve it; restarts near 1.2 give 1)
        assert abs(abs(integral) % 2.0 - 1.0) < 0.15
