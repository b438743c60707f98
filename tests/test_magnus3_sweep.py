"""Magnus order-3 (6th order) fused-sweep tests.

``fused_sweep_solve(magnus_order=3)`` uses the 3-point Gauss-Legendre
commutator rule (Blanes et al.; same math as
``fixed_step_solvers.get_exponential_take_step`` magnus_order=3,
ref ``/root/reference/qiskit_dynamics/solvers/fixed_step_solvers.py:524-543``)
on the batch-major XLA engine and the polynomial-expanded engine. It buys
~2.5x larger steps at equal accuracy.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qiskit_dynamics_tpu import Signal, Solver
from qiskit_dynamics_tpu.exceptions import DynamicsError
from qiskit_dynamics_tpu.models import LindbladModel
from qiskit_dynamics_tpu.solvers import fused_sweep_solve


@pytest.fixture(scope="module")
def lindblad_setup():
    dim = 4
    a_op = np.diag(np.sqrt(np.arange(1, dim)), 1)
    N_op = np.diag(np.arange(dim, dtype=float))
    H0 = 2 * np.pi * (5.0 * N_op - 0.33 / 2 * (N_op @ N_op - N_op))
    Hd = 2 * np.pi * 0.02 * (a_op + a_op.conj().T)
    diss = [np.sqrt(0.01) * a_op]
    model = LindbladModel(
        static_hamiltonian=H0, hamiltonian_operators=[Hd],
        static_dissipators=diss, rotating_frame=np.diag(H0), vectorized=True,
    )
    solver = Solver(
        static_hamiltonian=H0, hamiltonian_operators=[Hd],
        static_dissipators=diss, rotating_frame=np.diag(H0),
    )
    rho0 = np.zeros((dim, dim), dtype=complex)
    rho0[1, 1] = 1.0
    sig = lambda amp: ([Signal(lambda t: amp, carrier_freq=5.0)], None)
    return model, solver, rho0, sig


class TestMagnus3Accuracy:
    @pytest.mark.parametrize("engine,kwargs", [
        ("poly", {}),
        ("xla", {}),
    ])
    def test_sixth_order_vs_adaptive(self, lindblad_setup, engine, kwargs):
        model, solver, rho0, sig = lindblad_setup
        amps = jnp.linspace(0.2, 1.0, 3)
        out = fused_sweep_solve(
            model, sig, amps, t_span=(0.0, 5.0), max_dt=0.05, y0=rho0,
            sweep_engine=engine, magnus_order=3, **kwargs,
        )
        for i, a in enumerate(np.asarray(amps)):
            r = solver.solve(
                t_span=[0.0, 5.0], y0=rho0,
                signals=[Signal(lambda t, a=a: a, carrier_freq=5.0)],
                method="DOP853", atol=1e-13, rtol=1e-13,
            )
            err = np.max(np.abs(np.asarray(out[i]) - np.asarray(r.y[-1])))
            assert err < 5e-6, (engine, i, err)

    def test_order3_beats_order2_at_same_dt(self, lindblad_setup):
        """At dt where the 4th-order rule's truncation dominates, the
        6th-order rule must be substantially more accurate."""
        model, solver, rho0, sig = lindblad_setup
        amps = jnp.asarray([1.0])
        kw = dict(t_span=(0.0, 5.0), max_dt=0.05, y0=rho0, sweep_engine="xla")
        out3 = fused_sweep_solve(model, sig, amps, magnus_order=3, **kw)
        out2 = fused_sweep_solve(model, sig, amps, magnus_order=2, **kw)
        r = solver.solve(
            t_span=[0.0, 5.0], y0=rho0,
            signals=[Signal(lambda t: 1.0, carrier_freq=5.0)],
            method="DOP853", atol=1e-13, rtol=1e-13,
        )
        ref = np.asarray(r.y[-1])
        err3 = np.max(np.abs(np.asarray(out3[0]) - ref))
        err2 = np.max(np.abs(np.asarray(out2[0]) - ref))
        assert err3 < err2 / 10, (err3, err2)

    def test_grad_through_magnus3(self, lindblad_setup):
        model, _, rho0, sig = lindblad_setup
        amps = jnp.linspace(0.2, 1.0, 4)

        def loss(a):
            yf = fused_sweep_solve(
                model, sig, a, t_span=(0.0, 2.0), max_dt=0.05, y0=rho0,
                sweep_engine="xla", magnus_order=3,
            )
            return jnp.mean(jnp.abs(yf[:, 1, 1]) ** 2)

        g = jax.grad(loss)(amps)
        eps = 1e-6
        fd = (loss(amps + eps) - loss(amps - eps)) / (2 * eps)
        np.testing.assert_allclose(float(jnp.sum(g)), float(fd), rtol=1e-6)


class TestMagnus3Validation:
    def test_unknown_engine_rejected(self, lindblad_setup):
        model, _, rho0, sig = lindblad_setup
        with pytest.raises(DynamicsError, match="sweep_engine"):
            fused_sweep_solve(
                model, sig, jnp.ones(2), t_span=(0.0, 1.0), max_dt=0.05,
                y0=rho0, sweep_engine="pallas", magnus_order=3,
            )

    def test_bad_order_rejected(self, lindblad_setup):
        model, _, rho0, sig = lindblad_setup
        with pytest.raises(DynamicsError, match="magnus_order"):
            fused_sweep_solve(
                model, sig, jnp.ones(2), t_span=(0.0, 1.0), max_dt=0.05,
                y0=rho0, magnus_order=4,
            )


class TestPolyEngine:
    """sweep_engine='poly': the polynomial-expanded Magnus engine
    (ops/polynomial_sweep.py) — the per-member batched commutator matmuls
    collapse into one (B, Q) @ (Q, n^2) contraction against host-expanded
    monomial matrices. Same rule, same Horner polynomial."""

    @pytest.mark.parametrize("mo", [2, 3])
    def test_poly_matches_xla(self, lindblad_setup, mo):
        model, _, rho0, sig = lindblad_setup
        amps = jnp.linspace(0.2, 1.0, 4)
        kw = dict(t_span=(0.0, 2.0), max_dt=0.05, y0=rho0, magnus_order=mo)
        out_p = fused_sweep_solve(model, sig, amps, sweep_engine="poly", **kw)
        out_x = fused_sweep_solve(model, sig, amps, sweep_engine="xla", **kw)
        np.testing.assert_allclose(
            np.asarray(out_p), np.asarray(out_x), atol=1e-12, rtol=0
        )

    def test_poly_matches_xla_hamiltonian_vector(self, lindblad_setup):
        """Pure Hamiltonian model with a vector y0 (non-vectorized path)."""
        dim = 4
        a_op = np.diag(np.sqrt(np.arange(1, dim)), 1)
        N_op = np.diag(np.arange(dim, dtype=float))
        H0 = 2 * np.pi * (5.0 * N_op - 0.33 / 2 * (N_op @ N_op - N_op))
        Hd = 2 * np.pi * 0.02 * (a_op + a_op.conj().T)
        solver = Solver(
            static_hamiltonian=H0, hamiltonian_operators=[Hd],
            rotating_frame=np.diag(H0),
        )
        y0 = np.zeros(dim, dtype=complex)
        y0[0] = 1.0
        amps = jnp.linspace(0.2, 1.0, 3)
        sigh = lambda amp: [Signal(lambda t: amp, carrier_freq=5.0)]
        kw = dict(
            t_span=(0.0, 2.0), max_dt=0.05, y0=y0, magnus_order=3,
            rwa_signal_map=solver._rwa_signal_map,
        )
        out_p = fused_sweep_solve(
            solver.model, sigh, amps, sweep_engine="poly", **kw
        )
        out_x = fused_sweep_solve(
            solver.model, sigh, amps, sweep_engine="xla", **kw
        )
        np.testing.assert_allclose(
            np.asarray(out_p), np.asarray(out_x), atol=1e-12, rtol=0
        )

    def test_poly_trajectories_match_xla(self, lindblad_setup):
        model, _, rho0, sig = lindblad_setup
        amps = jnp.linspace(0.2, 1.0, 2)
        t_eval = [0.5, 1.0, 2.0]
        kw = dict(
            t_span=(0.0, 2.0), max_dt=0.05, y0=rho0, magnus_order=3,
            t_eval=t_eval,
        )
        out_p = fused_sweep_solve(model, sig, amps, sweep_engine="poly", **kw)
        out_x = fused_sweep_solve(model, sig, amps, sweep_engine="xla", **kw)
        np.testing.assert_allclose(
            np.asarray(out_p), np.asarray(out_x), atol=1e-12, rtol=0
        )

    def test_poly_grad_matches_xla(self, lindblad_setup):
        """The poly engine is plain jnp + scan: gradients flow through the
        expansion contraction and must match the xla engine's."""
        model, _, rho0, sig = lindblad_setup
        amps = jnp.linspace(0.3, 0.9, 3)

        def loss(a, engine):
            out = fused_sweep_solve(
                model, sig, a, t_span=(0.0, 1.0), max_dt=0.05, y0=rho0,
                magnus_order=3, sweep_engine=engine,
            )
            return jnp.mean(jnp.abs(out[:, 1, 1]))

        g_p = jax.grad(lambda a: loss(a, "poly"))(amps)
        g_x = jax.grad(lambda a: loss(a, "xla"))(amps)
        np.testing.assert_allclose(np.asarray(g_p), np.asarray(g_x), atol=1e-10)
