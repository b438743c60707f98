"""solve_ode / solve_lmde tests: every method against closed-form solutions
and cross-method agreement (mirrors reference test strategy, SURVEY §4)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.linalg import expm

from qiskit_dynamics_tpu.models import HamiltonianModel, GeneratorModel, LindbladModel
from qiskit_dynamics_tpu.signals import Signal, DiscreteSignal
from qiskit_dynamics_tpu.solvers import solve_ode, solve_lmde
from qiskit_dynamics_tpu.exceptions import DynamicsError

X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)

# --- closed-form problem: constant generator --------------------------------
G_CONST = -1j * 2 * np.pi * (0.3 * X + 0.1 * Z)
Y0 = np.array([1.0, 0.0], dtype=complex)
T_F = 1.3


def const_rhs(t, y):
    return G_CONST @ y


def const_gen(t):
    return jnp.asarray(G_CONST)


EXPECTED = expm(T_F * G_CONST) @ Y0

ODE_METHODS_TO_TEST = [
    "RK45", "DOP853", "BDF", "Radau", "LSODA",
    "jax_odeint", "tpu_dopri5", "tpu_dop853",
]


@pytest.mark.parametrize("method", ODE_METHODS_TO_TEST)
def test_ode_methods_constant_generator(method):
    results = solve_ode(const_rhs, [0.0, T_F], Y0, method=method, atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(results.y[-1], EXPECTED, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("method", ["RK4", "jax_RK4"])
def test_fixed_step_ode_methods(method):
    results = solve_ode(const_rhs, [0.0, T_F], Y0, method=method, max_dt=0.001)
    np.testing.assert_allclose(results.y[-1], EXPECTED, atol=1e-8, rtol=1e-8)


LMDE_METHODS_TO_TEST = [
    ("scipy_expm", {"max_dt": 0.01}),
    ("jax_expm", {"max_dt": 0.01}),
    ("jax_expm_parallel", {"max_dt": 0.01}),
    ("jax_RK4_parallel", {"max_dt": 0.001}),
    ("lanczos_diag", {"max_dt": 0.01, "k_dim": 2}),
    ("jax_lanczos_diag", {"max_dt": 0.01, "k_dim": 2}),
]


@pytest.mark.parametrize("method,kwargs", LMDE_METHODS_TO_TEST)
def test_lmde_methods_constant_generator(method, kwargs):
    results = solve_lmde(const_gen, [0.0, T_F], Y0, method=method, **kwargs)
    np.testing.assert_allclose(results.y[-1], EXPECTED, atol=1e-6, rtol=1e-6)


def test_t_eval_points():
    t_eval = np.array([0.3, 0.6, 1.0])
    for method in ["DOP853", "tpu_dopri5", "jax_odeint"]:
        results = solve_ode(const_rhs, [0.0, T_F], Y0, method=method,
                            t_eval=t_eval, atol=1e-10, rtol=1e-10)
        assert len(results.t) == 3
        for i, t in enumerate(t_eval):
            np.testing.assert_allclose(
                results.y[i], expm(t * G_CONST) @ Y0, atol=1e-6,
                err_msg=f"method={method} t={t}",
            )


def test_t_eval_with_endpoints():
    """t_eval including the endpoints of t_span."""
    t_eval = np.array([0.0, 0.5, T_F])
    results = solve_ode(const_rhs, [0.0, T_F], Y0, method="tpu_dopri5",
                        t_eval=t_eval, atol=1e-10, rtol=1e-10)
    assert len(results.t) == 3
    np.testing.assert_allclose(results.y[0], Y0, atol=1e-8)
    np.testing.assert_allclose(results.y[2], EXPECTED, atol=1e-6)


def test_backwards_integration():
    for method in ["DOP853", "tpu_dopri5", "jax_odeint"]:
        results = solve_ode(const_rhs, [T_F, 0.0], EXPECTED, method=method,
                            atol=1e-10, rtol=1e-10)
        np.testing.assert_allclose(results.y[-1], Y0, atol=1e-6,
                                   err_msg=f"method={method}")


def test_model_solve_frame_fast_path():
    """Solving a HamiltonianModel in a rotating frame matches direct expm series."""
    nu = 5.0
    H0 = 2 * np.pi * nu * Z / 2
    r = 0.1
    ham = HamiltonianModel(
        static_operator=H0,
        operators=[2 * np.pi * r * X / 2],
        signals=[Signal(1.0, carrier_freq=nu)],
        rotating_frame=H0,
    )
    T = 1.0 / r / 4  # quarter Rabi period at resonance
    for method, kwargs in [("DOP853", {}), ("tpu_dopri5", {}), ("jax_odeint", {})]:
        results = solve_ode(ham, [0.0, T], Y0, method=method, atol=1e-10, rtol=1e-10, **kwargs)
        # in rotating frame + RWA limit, P(excited) ~ sin^2(pi r t / 2 / (1/r)) ...
        # exact cross-check: RK4 with tiny step
        ref = solve_ode(ham, [0.0, T], Y0, method="RK4", max_dt=1e-4)
        np.testing.assert_allclose(results.y[-1], ref.y[-1], atol=1e-5, rtol=1e-5,
                                   err_msg=f"method={method}")


def test_solve_lmde_rejects_unvectorized_lindblad():
    model = LindbladModel(
        static_hamiltonian=Z, dissipator_operators=[X], dissipator_signals=[Signal(1.0)]
    )
    with pytest.raises(DynamicsError):
        solve_lmde(model, [0, 1], np.eye(2, dtype=complex), method="scipy_expm", max_dt=0.1)


def test_vectorized_lindblad_lmde():
    model = LindbladModel(
        static_hamiltonian=Z,
        dissipator_operators=[0.1 * X],
        dissipator_signals=[Signal(1.0)],
        vectorized=True,
    )
    rho0 = np.array([[1.0, 0.0], [0.0, 0.0]], dtype=complex).flatten(order="F")
    res_expm = solve_lmde(model, [0, 1.0], rho0, method="scipy_expm", max_dt=0.01)
    res_ode = solve_ode(model, [0, 1.0], rho0, method="DOP853", atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(res_expm.y[-1], res_ode.y[-1], atol=1e-6)
    # trace preservation
    rho_f = res_expm.y[-1].reshape(2, 2, order="F")
    np.testing.assert_allclose(np.trace(rho_f), 1.0, atol=1e-8)


def test_magnus_orders():
    """Higher Magnus order: better accuracy at same step size for t-dependent G."""
    ham = HamiltonianModel(
        static_operator=Z,
        operators=[X],
        signals=[Signal(1.0, carrier_freq=1.0)],
    )
    y0 = np.array([1.0, 0.0], dtype=complex)
    ref = solve_ode(ham, [0, 1.0], y0, method="DOP853", atol=1e-12, rtol=1e-12)
    errs = []
    for order in [1, 2, 3]:
        res = solve_lmde(ham, [0, 1.0], y0, method="scipy_expm", max_dt=0.05, magnus_order=order)
        errs.append(np.max(np.abs(res.y[-1] - ref.y[-1])))
    assert errs[1] < errs[0]
    assert errs[2] < errs[1]


def test_tpu_adaptive_jit_and_grad():
    """The native adaptive solver works under jit and reverse-mode grad."""

    def solve_final(amp):
        sig = Signal(amp, carrier_freq=0.0)
        ham = HamiltonianModel(
            static_operator=Z, operators=[X], signals=[sig], validate=False
        )
        res = solve_ode(ham, [0.0, 1.0], jnp.asarray(Y0), method="tpu_dopri5",
                        rtol=1e-8, atol=1e-10, max_steps=512)
        return jnp.abs(res.y[-1][1]) ** 2

    p = jax.jit(solve_final)(0.5)
    p2 = solve_final(0.5)
    np.testing.assert_allclose(p, p2, rtol=1e-8)

    g = jax.grad(solve_final)(0.5)
    # finite difference check
    eps = 1e-5
    fd = (solve_final(0.5 + eps) - solve_final(0.5 - eps)) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-3, atol=1e-6)


def test_tpu_adaptive_accuracy_vs_scipy():
    """tpu_dop853 matches scipy DOP853 to 1e-8 on a driven system."""
    ham = HamiltonianModel(
        static_operator=5 * Z, operators=[X],
        signals=[Signal(0.5, carrier_freq=5.0 / np.pi)],
        rotating_frame=5 * Z,
    )
    y0 = np.array([1.0, 0.0], dtype=complex)
    res_sp = solve_ode(ham, [0, 2.0], y0, method="DOP853", atol=1e-12, rtol=1e-12)
    res_native = solve_ode(ham, [0, 2.0], y0, method="tpu_dop853", atol=1e-12, rtol=1e-12)
    np.testing.assert_allclose(res_native.y[-1], res_sp.y[-1], atol=1e-8, rtol=1e-8)


def test_tpu_adaptive_max_steps_nan_poisons():
    res = solve_ode(const_rhs, [0.0, 100.0], Y0, method="tpu_dopri5", max_steps=4)
    assert np.all(np.isnan(np.real(res.y[-1])))


def test_custom_odesolver_subclass_method():
    """An arbitrary scipy ``OdeSolver`` subclass passes straight through as
    ``method=`` (reference solver_functions.py:129-217 accepts any
    ``OdeSolver`` type, not just the named scipy strings)."""
    from scipy.integrate import RK45

    calls = {"n": 0}

    class CountingRK45(RK45):
        def __init__(self, *args, **kwargs):
            calls["n"] += 1
            super().__init__(*args, **kwargs)

    ham = HamiltonianModel(
        static_operator=5 * Z, operators=[X],
        signals=[Signal(0.5, carrier_freq=5.0 / np.pi)],
        rotating_frame=5 * Z,
    )
    res = solve_ode(
        ham, [0, 1.0], Y0, method=CountingRK45, atol=1e-10, rtol=1e-10
    )
    assert calls["n"] == 1  # the subclass itself was instantiated
    ref = solve_ode(ham, [0, 1.0], Y0, method="RK45", atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(res.y[-1], ref.y[-1], atol=1e-8, rtol=1e-8)


def test_custom_odesolver_subclass_through_solver_class():
    """The Solver front end forwards OdeSolver subclasses too."""
    from scipy.integrate import DOP853
    from qiskit_dynamics_tpu import Solver

    class MyDOP853(DOP853):
        pass

    solver = Solver(
        static_hamiltonian=5 * Z, hamiltonian_operators=[X],
        rotating_frame=5 * Z,
    )
    res = solver.solve(
        t_span=[0, 1.0], y0=Y0,
        signals=[Signal(0.5, carrier_freq=5.0 / np.pi)],
        method=MyDOP853, atol=1e-10, rtol=1e-10,
    )
    ref = solver.solve(
        t_span=[0, 1.0], y0=Y0,
        signals=[Signal(0.5, carrier_freq=5.0 / np.pi)],
        method="DOP853", atol=1e-10, rtol=1e-10,
    )
    np.testing.assert_allclose(res.y[-1], ref.y[-1], atol=1e-8, rtol=1e-8)
