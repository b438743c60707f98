"""Flagship benchmark models (BASELINE.md configs).

The headline benchmark (BASELINE.json north star) is a 10k-point amplitude
sweep of a two-transmon cross-resonance ``Solver`` — dim=16, rotating frame +
RWA — mirroring the reference's user-guide cross-resonance example
(``/root/reference/docs/tutorials/optimizing_pulse_sequence.rst`` and
``how_to_configure_simulations.rst``). These builders are shared by
``bench.py`` and ``__graft_entry__.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .solvers import Solver
from .signals import Signal

__all__ = ["cr_solver", "rabi_solver", "fused_cr_sweep", "dyson_transmon_solver"]


def _transmon_ops(dim: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    a = np.diag(np.sqrt(np.arange(1, dim)), 1)
    adag = a.conj().T
    N = np.diag(np.arange(dim))
    return a, adag, N


def cr_solver(
    dim: int = 4,
    w0: float = 5.0,
    w1: float = 5.1,
    alpha0: float = -0.33,
    alpha1: float = -0.33,
    J: float = 0.002,
    rwa_cutoff_freq: Optional[float] = None,
):
    """Two-transmon cross-resonance Solver (drive on qubit 0 at qubit 1's freq).

    ``dim`` levels per transmon (total Hilbert dim ``dim**2``; dim=4 -> 16).
    Rotating frame = diagonal of the static Hamiltonian; RWA cutoff defaults to
    twice the mean transmon frequency.

    Returns:
        (solver, drive_freq): the configured ``Solver`` and the CR drive
        carrier frequency (= target-qubit frequency).
    """
    a, adag, N = _transmon_ops(dim)
    ident = np.eye(dim)

    def two(op, which):
        return np.kron(op, ident) if which == 0 else np.kron(ident, op)

    H0 = (
        2 * np.pi * w0 * two(N, 0)
        + np.pi * alpha0 * two(N @ (N - ident), 0)
        + 2 * np.pi * w1 * two(N, 1)
        + np.pi * alpha1 * two(N @ (N - ident), 1)
        + 2 * np.pi * J * (np.kron(adag, a) + np.kron(a, adag))
    )
    drive0 = 2 * np.pi * two(a + adag, 0)

    if rwa_cutoff_freq is None:
        # mean transmon frequency: keeps the ~|w0-w1| rotating terms, drops the
        # ~(w0+w1) counter-rotating ones with a wide margin on both sides
        rwa_cutoff_freq = (w0 + w1) / 2

    solver = Solver(
        static_hamiltonian=H0,
        hamiltonian_operators=[drive0],
        rotating_frame=np.diag(H0),
        rwa_cutoff_freq=rwa_cutoff_freq,
        rwa_carrier_freqs=[w1],
    )
    return solver, w1


def rabi_solver(nu: float = 5.0):
    """Single-qubit Rabi Solver (BASELINE config 1)."""
    X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
    Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
    solver = Solver(
        static_hamiltonian=2 * np.pi * nu * Z / 2,
        hamiltonian_operators=[2 * np.pi * X / 2],
        rotating_frame=2 * np.pi * nu * Z / 2,
    )
    return solver, nu


def fused_cr_sweep(
    solver,
    drive_freq: float,
    amps,
    t_final: float = 100.0,
    dt: float = 0.5,
    amp_scale: float = 0.02,
    order: int = 8,
):
    """CR amplitude sweep through :func:`.solvers.fused_sweep_solve`.

    The whole fixed-step Magnus-2 sweep of the (RWA'd) model of ``solver``
    runs as one device program. Returns (B, dim) final-state populations,
    matching
    ``Solver.solve(..., method='jax_expm', magnus_order=2)`` up to Taylor
    truncation.
    """
    import jax.numpy as jnp

    from .solvers.fused_sweep import fused_sweep_solve

    model = solver.model
    dim = model.dim
    y0 = np.zeros(dim, dtype=complex)
    y0[0] = 1.0

    def signals_fn(amp):
        return [Signal(lambda t: amp * amp_scale, carrier_freq=drive_freq)]

    yf = fused_sweep_solve(
        model,
        signals_fn,
        jnp.asarray(amps),
        t_span=(0.0, t_final),
        max_dt=dt,
        y0=y0,
        expm_order=order,
        rwa_signal_map=solver._rwa_signal_map,
    )
    return jnp.abs(yf) ** 2


def expm_chain(
    generators, dt: float, y0, order: int = 12, squarings: int = 2,
):
    """Sustained expm-propagator chain: ``y <- expm(G_t dt) @ y`` over steps.

    A single small expm is dispatch-latency bound; production propagation is
    a CHAIN of steps under one jit (``lax.scan`` over
    :func:`~qiskit_dynamics_tpu.ops.expm.expm_taylor`) — this helper measures
    that sustained regime.

    Args:
        generators: (T, ..., n, n) per-step (optionally batched) generators.
        dt: step size.
        y0: (..., n, m) states/propagators to which the chain is applied.

    Returns:
        (..., n, m) final states.
    """
    from .ops.expm import expm_taylor

    def step(y, g):
        return expm_taylor(g * dt, order=order, squarings=squarings) @ y, None

    yf, _ = jax.lax.scan(step, jnp.asarray(y0), jnp.asarray(generators))
    return yf


def three_transmon_backend(
    dim: int = 3,
    dt: float = 0.1,
    rwa_cutoff_freq: Optional[float] = None,
):
    """BASELINE config 5: a 3-transmon chain DynamicsBackend.

    Built through ``from_config`` (exercising the Hamiltonian string parser)
    with nearest-neighbor exchange couplings and a drive channel per
    transmon. Frequencies are in the same arbitrary units as the reference
    demos (GHz-scale numbers scaled down by 1e9 with dt in ns-scale units).
    """
    from .backend import DynamicsBackend

    v = [5.0, 5.1, 5.2]
    alpha = [-0.33, -0.33, -0.33]
    j = 0.002
    h_str = []
    for q in range(3):
        h_str.append(f"2*np.pi*v{q}*N{q}")
        h_str.append(f"np.pi*alpha{q}*(N{q}*N{q}-N{q})")
        h_str.append(f"2*np.pi*r*X{q}||D{q}")
    h_str.append("2*np.pi*j*(Sp0*Sm1+Sm0*Sp1)")
    h_str.append("2*np.pi*j*(Sp1*Sm2+Sm1*Sp2)")
    ham = {
        "h_str": h_str,
        "qub": {"0": dim, "1": dim, "2": dim},
        "vars": {
            **{f"v{q}": v[q] for q in range(3)},
            **{f"alpha{q}": alpha[q] for q in range(3)},
            "j": j,
            "r": 0.02,
        },
    }
    backend = DynamicsBackend.from_config(
        hamiltonian_dict=ham,
        dt=dt,
        channel_carrier_freqs={f"d{q}": v[q] for q in range(3)},
        rwa_cutoff_freq=rwa_cutoff_freq,
    )
    return backend


def gaussian_amp_schedules(amps, duration: int = 64, sigma: float = 16.0):
    """One drive-amplitude sweep as a schedule batch (shared shape -> the
    Solver's padded-schedule jit path compiles ONCE for the whole batch)."""
    from .pulse import Schedule
    from .pulse.library import Gaussian
    from .pulse.schedule import (
        Acquire,
        AcquireChannel,
        DriveChannel,
        MemorySlot,
        Play,
    )

    schedules = []
    for amp in np.asarray(amps):
        sched = Schedule(name=f"amp_{amp}")
        sched.append(Play(Gaussian(duration=duration, amp=float(amp), sigma=sigma), DriveChannel(0)))
        for q in range(3):
            sched.insert(duration, Acquire(1, AcquireChannel(q), mem_slot=MemorySlot(q)))
        schedules.append(sched)
    return schedules


def dyson_transmon_solver(
    dim: int = 10,
    nu: float = 5.0,
    alpha: float = -0.33,
    r: float = 0.02,
    dt: float = 0.1,
    chebyshev_order: int = 1,
    expansion_order: int = 6,
):
    """BASELINE config 4: single-transmon ``DysonSolver`` (Dysolve stepping).

    dim-10 transmon in its own rotating frame, one drive at the transmon
    frequency, coarse dt = 0.1 (the perturbative solvers' whole point is
    stepping far beyond the carrier period at fixed precompute; reference
    perf claim: ``/root/reference/docs/userguide/perturbative_solvers.rst:70-74``).

    Returns:
        (dyson_solver, nu): the solver and the drive carrier frequency.
    """
    return _perturbative_transmon_solver(
        "dyson", dim, nu, alpha, r, dt, chebyshev_order, expansion_order
    )


def magnus_transmon_solver(
    dim: int = 10,
    nu: float = 5.0,
    alpha: float = -0.33,
    r: float = 0.02,
    dt: float = 0.1,
    chebyshev_order: int = 1,
    expansion_order: int = 3,
):
    """BASELINE config 4, Magnus variant: same transmon as
    :func:`dyson_transmon_solver` stepped with ``MagnusSolver`` (per-step
    ``expm`` of the Magnus polynomial via the batched Taylor ``expm``;
    unitary per step, so coarser expansion orders hold).

    Returns:
        (magnus_solver, nu): the solver and the drive carrier frequency.
    """
    return _perturbative_transmon_solver(
        "magnus", dim, nu, alpha, r, dt, chebyshev_order, expansion_order
    )


def _perturbative_transmon_solver(
    kind, dim, nu, alpha, r, dt, chebyshev_order, expansion_order
):
    from .solvers import DysonSolver, MagnusSolver

    a, adag, N = _transmon_ops(dim)
    H0 = 2 * np.pi * nu * N + np.pi * alpha * N @ (N - np.eye(dim))
    G0 = -1j * H0
    G1 = -1j * 2 * np.pi * r * (a + adag)
    cls = DysonSolver if kind == "dyson" else MagnusSolver
    solver = cls(
        operators=[G1],
        rotating_frame=G0,
        dt=dt,
        carrier_freqs=[nu],
        chebyshev_orders=[chebyshev_order],
        expansion_order=expansion_order,
        atol=1e-12,
        rtol=1e-12,
    )
    return solver, nu
