r"""Batch-major XLA engine for fixed-step Magnus sweeps.

Per step: build each member's Gauss-point generators ``(B, n, n)``, combine
them with the Magnus-2 (4th order) or Magnus-3 (6th order) commutator rule,
and apply ``expm(M) y`` as a Horner mat-vec Taylor polynomial — the
propagator matrix is never formed. Batched complex matmuls under one
fixed-length ``lax.scan`` over time: no per-step host synchronisation, and
reverse-mode AD through the checkpointed scan stores only the per-step state.
``solvers.fused_sweep_solve`` runs it up to ``solve_dim`` 128 (above that the
polynomial-expanded engine, ``ops/polynomial_sweep.py``).

Reference math: Magnus-2 Gauss-point commutator rule
(``/root/reference/qiskit_dynamics/solvers/fixed_step_solvers.py:321-403``).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .trig_reduce import reduced_phase, split_array, split_const, step_time_df

# 2-point Gauss-Legendre nodes and the Magnus-2 commutator weight
_GAUSS_C1 = 0.5 - np.sqrt(3) / 6
_GAUSS_C2 = 0.5 + np.sqrt(3) / 6
_P2 = np.sqrt(3) / 12

# 3-point Gauss-Legendre nodes + Magnus order-3 (6th-order) combination
# coefficients (Blanes et al. 2009; same rule as
# solvers/fixed_step_solvers.get_exponential_take_step magnus_order=3)
_GAUSS3_D1 = 0.5 - np.sqrt(15) / 10
_GAUSS3_D2 = 0.5
_GAUSS3_D3 = 0.5 + np.sqrt(15) / 10
_M3_C0 = np.sqrt(15) / 3
_M3_C1 = 10.0 / 3


def split_omega_host(frame_omega):
    """f32 (hi, lo) split of a frequency array, host-side when possible.

    Must be called BEFORE the jit boundary: without x64 JAX casts f64 inputs
    to f32 at the boundary, losing exactly the bits the lo half preserves
    (the representation error ``w 2^-24 t`` dominates large-phase trig).
    Under x64, or for traced values (bits already gone), lo is zero.
    """
    if jax.config.jax_enable_x64:
        om = jnp.asarray(frame_omega)
        return om, jnp.zeros_like(om)
    try:
        om = np.asarray(frame_omega)
    except Exception:  # traced value
        om = jnp.asarray(frame_omega).astype(jnp.float32)
        return om, jnp.zeros_like(om)
    hi, lo = split_array(om)
    return jnp.asarray(hi), jnp.asarray(lo)


def _validate_eval_slots(eval_slots, T: int) -> int:
    """Validate a trajectory slot table; returns ``n_eval``.

    The non-negative entries must be exactly a permutation of
    ``range(n_eval)`` — a duplicate or gapped slot would leave trajectory
    slots unwritten (silent zeros) with no NaN-poison to flag it.
    """
    if len(eval_slots) != T:
        raise ValueError(f"eval_slots must have length T={T}")
    marked = sorted(int(s) for s in eval_slots if int(s) >= 0)
    if not marked:
        raise ValueError("eval_slots must mark at least one step")
    if marked != list(range(len(marked))):
        raise ValueError(
            "the non-negative eval_slots values must be exactly a "
            f"permutation of range(n_eval); got {marked}."
        )
    return len(marked)


__all__ = ["sweep_expm_magnus2_xla", "split_omega_host"]


def sweep_expm_magnus2_xla(
    static_op, operators, frame_omega, coefficients, y0,
    dt, t0=0.0, order=8, hermitian=False, eval_slots=None,
    frame_omega_lo=None, magnus_order=2,
):
    """Public shim over :func:`_sweep_expm_magnus2_xla_jit`: splits the frame
    frequency matrix into an f32 (hi, lo) pair host-side (see
    :func:`split_omega_host`). Arguments documented below."""
    if frame_omega_lo is None:
        frame_omega, frame_omega_lo = split_omega_host(frame_omega)
    return _sweep_expm_magnus2_xla_jit(
        static_op, operators, frame_omega, frame_omega_lo, coefficients, y0,
        dt=dt, t0=t0, order=order, hermitian=hermitian, eval_slots=eval_slots,
        magnus_order=magnus_order,
    )


@functools.partial(
    jax.jit,
    static_argnames=("dt", "t0", "order", "hermitian", "eval_slots", "magnus_order"),
)
def _sweep_expm_magnus2_xla_jit(
    static_op,
    operators,
    frame_omega,
    frame_omega_lo,
    coefficients,
    y0,
    dt: float,
    t0: float = 0.0,
    order: int = 8,
    hermitian: bool = False,
    eval_slots=None,
    magnus_order: int = 2,
):
    r"""Fixed-step Magnus sweep solve, batch-major XLA implementation.

    Args:
        static_op: (n, n) static generator in the frame basis.
        operators: (k, n, n) signal operators in the frame basis.
        frame_omega, frame_omega_lo: (n, n) frame frequency differences as
            an f32 (hi, lo) split.
        coefficients: (T, n_gauss, k, B) real Gauss-point signal samples
            (``n_gauss = magnus_order``).
        y0: (n, B) complex frame-basis states (or batch-major, below).
        dt, t0: uniform step size and initial time.
        order: Taylor order of the Horner ``expm`` action.
        hermitian: all generators anti-Hermitian (one-matmul commutator).
        eval_slots: optional static per-step trajectory slots (-1 = none),
            producing an ``(n_eval, n, B)`` trajectory second output.
        magnus_order: 2 (4th order, 2-point Gauss) or 3 (6th order, 3-point
            Gauss).

    ``y0`` may alternatively be 3d ``(B, n, m)`` batch-major — ``m`` state
    columns per sweep member sharing one generator (unitary/propagator
    sweeps): the O(n^3) generator/commutator work is then done ONCE per
    member instead of per column, and outputs are ``(B, n, m)``
    (+ ``(n_eval, B, n, m)`` trajectory).
    """
    if magnus_order not in (2, 3):
        raise ValueError(f"magnus_order must be 2 or 3, got {magnus_order!r}")
    cplx = jnp.complex64 if not jax.config.jax_enable_x64 else jnp.complex128
    real = jnp.float32 if not jax.config.jax_enable_x64 else jnp.float64
    static = jnp.asarray(static_op).astype(cplx)
    ops = jnp.asarray(operators).astype(cplx)
    omega = jnp.asarray(frame_omega).astype(real)
    omega_lo = jnp.asarray(frame_omega_lo).astype(real)
    coef = jnp.asarray(coefficients).astype(real)
    T = coef.shape[0]
    y0 = jnp.asarray(y0).astype(cplx)
    batch_major = y0.ndim == 3
    if batch_major:
        y = y0  # (B, n, m)
    else:
        y = jnp.swapaxes(y0, 0, 1)[..., None]  # (B, n, 1)

    f32_mode = real == jnp.float32

    def frame_phase(idx, gauss_c):
        """(n, n) frame phase ``omega * tau`` at ``tau = t0 + (idx+c) dt``.

        f32: EFT step time + mod-2pi reduction (ops/trig_reduce.py), so
        large absolute phases keep f32 trig accurate."""
        if f32_mode:
            return reduced_phase(
                (omega, omega_lo),
                step_time_df(
                    idx.astype(real), split_const(dt), split_const(t0 + gauss_c * dt)
                ),
            )
        return omega * (t0 + (idx.astype(real) + gauss_c) * dt)

    def generator(coef_step, ph):
        """(k, B) coefficients + (n, n) phase -> (B, n, n) rotated generator."""
        A = static[None] + jnp.einsum("kb,kij->bij", coef_step.astype(cplx), ops)
        phase = jnp.exp(1j * ph.astype(cplx))  # (n, n)
        return A * phase[None]

    c1 = 0.5 * dt
    c2 = _P2 * dt * dt

    n_eval = 0
    slots = None
    if eval_slots is not None:
        n_eval = _validate_eval_slots(eval_slots, T)
        slots = jnp.asarray(np.asarray(eval_slots, dtype=np.int32))

    def comm(A, B):
        """[A, B]; with anti-Hermitian operands AB = (BA)^dagger, so one
        batched matmul + a conj-transpose replaces two matmuls."""
        P = A @ B
        if hermitian:
            return P - jnp.conj(jnp.swapaxes(P, -1, -2))
        return P - B @ A

    def magnus_matrix(idx, coef_step):
        if magnus_order == 2:
            G1 = generator(coef_step[0], frame_phase(idx, _GAUSS_C1))
            G2 = generator(coef_step[1], frame_phase(idx, _GAUSS_C2))
            return c1 * (G1 + G2) + c2 * comm(G2, G1)
        # order 3 (6th order; Blanes et al., same rule as
        # fixed_step_solvers.get_exponential_take_step magnus_order=3)
        G1 = generator(coef_step[0], frame_phase(idx, _GAUSS3_D1))
        G2 = generator(coef_step[1], frame_phase(idx, _GAUSS3_D2))
        G3 = generator(coef_step[2], frame_phase(idx, _GAUSS3_D3))
        a1 = dt * G2
        a2 = (_M3_C0 * dt) * (G3 - G1)
        a3 = (_M3_C1 * dt) * (G3 - 2.0 * G2 + G1)
        C1 = comm(a1, a2)
        C2 = comm(2.0 * a3 + C1, a1) / 60.0
        return a1 + a3 / 12.0 + comm(-20.0 * a1 - a3 + C1, a2 + C2) / 240.0

    def step(carry, xs):
        y, evals = carry
        idx, coef_step = xs
        M = magnus_matrix(idx, coef_step)
        # y <- expm(M) y, Horner mat-vec Taylor
        v = y
        for kk in range(order, 0, -1):
            v = y + jnp.einsum("bij,bjm->bim", M, v) / kk
        if n_eval > 0:
            slot = slots[idx]
            updated = jax.lax.dynamic_update_index_in_dim(
                evals, v, jnp.maximum(slot, 0), axis=0
            )
            evals = jnp.where(slot >= 0, updated, evals)
        return (v, evals), None

    evals0 = (
        jnp.zeros((n_eval,) + y.shape, dtype=y.dtype) if n_eval > 0 else jnp.zeros(())
    )
    # checkpoint the step: under reverse-mode AD only the per-step carry
    # is stored — the (B, n, n) generators/M are recomputed in the
    # backward pass instead of being saved T-fold in HBM
    (y, evals), _ = jax.lax.scan(
        jax.checkpoint(step), (y, evals0), (jnp.arange(T), coef)
    )
    if batch_major:
        if n_eval > 0:
            return y, evals  # (B, n, m), (n_eval, B, n, m)
        return y
    y = jnp.swapaxes(y[..., 0], 0, 1)  # (n, B)
    if n_eval > 0:
        return y, jnp.moveaxis(evals[..., 0], 2, 1)  # (n_eval, n, B)
    return y
