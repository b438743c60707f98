r"""Steady-state and Floquet analysis.

Capabilities beyond the reference (qiskit-dynamics has no steady-state or
Floquet API) for its core audience — open-system characterization and
periodically driven qubit control:

- :func:`lindblad_steady_state` / :func:`lindblad_steady_state_sweep`:
  :math:`\rho_{ss}` with :math:`\mathcal{L}(\rho_{ss}) = 0` for a
  (vectorized) Lindblad generator, as one batched linear
  solve — differentiable, so dissipative calibration targets (e.g. fitting
  :math:`T_1`/:math:`T_\phi` from saturation spectroscopy) can sit inside
  ``jax.grad``.
- :func:`floquet_basis`: Floquet quasienergies/modes of a time-periodic
  generator from its one-period propagator (device solve through any
  ``solve_lmde`` method, host eigendecomposition).
- :func:`correlation_function` / :func:`spectrum`: two-time correlations
  :math:`\langle A(\tau) B(0)\rangle` via the quantum regression theorem,
  and the emission/absorption spectrum as ONE batched frequency-domain
  linear solve :math:`(i\omega - \mathcal{L})^{-1}` — no time integration,
  every frequency a column of one batched solve.

Steady-state method: with the column-stacking convention
(``models/model_utils.py``), :math:`\mathrm{vec}(\rho_{ss})` spans the
nullspace of the :math:`(n^2, n^2)` superoperator :math:`L`. Instead of an
eigensolve (general ``eig`` runs only on the host), solve the trace-bordered normal
equations

.. math:: (L^\dagger L + v v^\dagger)\, x = v,
          \qquad v = \mathrm{vec}(I)/\sqrt{n},

whose unique solution for an irreducible Lindbladian is the trace-scaled
steady state: :math:`L^\dagger L` is PSD with kernel spanned by
:math:`\mathrm{vec}(\rho_{ss})`, and the rank-1 trace border makes the
system positive-definite because a physical steady state has nonzero
trace. One Hermitian solve, batched over sweep members.
For a degenerate steady-state manifold this returns the trace-normalized
element selected by the border (the maximally-mixed-direction projection);
pass ``check_residual`` tolerance to NaN-poison non-converged members
instead of returning them silently.

**Scaling limits.** :func:`lindblad_steady_state`,
:func:`lindblad_steady_state_sweep`, and :func:`spectrum` materialize the
dense :math:`(n^2, n^2)` superoperator and solve it directly —
:math:`O(n^4)` memory and :math:`O(n^6)` flops. That is the right trade at
``dim <= ~32`` (a dim-32 superoperator is 1024x1024 — 8 MB, one fast
solve); at dim 64 it is 134 MB per member and at dim 128 ~2 GB, so dense
breaks down between dim 32 and 128 depending on batch size. For larger
systems use :func:`lindblad_steady_state_iterative` and
:func:`spectrum_iterative` — matrix-free GMRES on the trace-bordered /
zero-mode-shifted systems with :math:`O(k\, n^3)`-per-apply superoperator
ACTIONS through the (sparse-capable) non-vectorized Lindblad collection,
never materializing :math:`L`; :func:`correlation_function` accepts
``vectorized=False`` models directly (matrix-apply evolution).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..exceptions import DynamicsError

__all__ = [
    "lindblad_steady_state",
    "lindblad_steady_state_iterative",
    "lindblad_steady_state_sweep",
    "floquet_basis",
    "FloquetResult",
    "correlation_function",
    "spectrum",
    "spectrum_iterative",
]


def _vec_col(mat):
    """Column-stacking vec of the trailing two axes."""
    return jnp.swapaxes(mat, -1, -2).reshape(mat.shape[:-2] + (-1,))


def _trace_weights(a_op):
    """Row vector ``w`` with ``Tr[a M] = w . vec_col(M)``: ``vec_col(a^T)``
    = the row-major flatten of ``a``."""
    return jnp.asarray(a_op).reshape(-1)


def _steady_from_superop(L, check_residual: Optional[float]):
    """Trace-bordered normal-equations steady state of superoperator(s)
    ``L`` with shape ``(..., n^2, n^2)``; returns ``(..., n, n)``."""
    n2 = L.shape[-1]
    n = int(round(np.sqrt(n2)))
    if n * n != n2:
        raise DynamicsError(f"superoperator dimension {n2} is not a square.")
    v = jnp.eye(n, dtype=L.dtype).T.reshape(-1) / np.sqrt(n)  # vec(I)/sqrt(n)
    LH = jnp.conj(jnp.swapaxes(L, -1, -2))
    A = LH @ L + v[:, None] * jnp.conj(v)[None, :]
    x = jnp.linalg.solve(A, jnp.broadcast_to(v, L.shape[:-2] + (n2,))[..., None])
    x = x[..., 0]
    if check_residual is not None:
        # NaN-poison members whose nullspace residual exceeds the tolerance
        # (no raises under trace — package convention)
        res = jnp.linalg.norm((L @ x[..., None])[..., 0], axis=-1)
        res = res / jnp.linalg.norm(x, axis=-1)
        x = jnp.where(
            (res <= check_residual)[..., None], x, jnp.full_like(x, jnp.nan)
        )
    # column-stacking unvec: vec index a = col*n + row
    rho = jnp.swapaxes(x.reshape(x.shape[:-1] + (n, n)), -1, -2)
    rho = 0.5 * (rho + jnp.conj(jnp.swapaxes(rho, -1, -2)))
    tr = jnp.trace(rho, axis1=-2, axis2=-1)[..., None, None]
    return rho / tr


def _validate_steady_model(model, allow_non_vectorized: bool = False):
    from ..models import LindbladModel

    if not isinstance(model, LindbladModel) or not (
        model.vectorized or allow_non_vectorized
    ):
        raise DynamicsError(
            "lindblad_steady_state requires a LindbladModel with vectorized=True."
        )
    if model._rotating_frame.frame_diag is not None:
        raise DynamicsError(
            "lindblad_steady_state requires rotating_frame=None: in a "
            "nontrivial frame the generator is time-dependent even for "
            "constant signals, so a static steady state is not defined. "
            "Build the model without a frame (the solve is one linear "
            "system — no stiffness to rotate away)."
        )


def lindblad_steady_state(model, time: float = 0.0, check_residual: Optional[float] = 1e-6):
    r"""Steady state :math:`\rho_{ss}` of a vectorized Lindblad model.

    The generator is evaluated at ``time`` with the model's current signals
    and treated as time-independent (use constant signals; for periodically
    driven systems see :func:`floquet_basis`).

    Args:
        model: ``LindbladModel`` with ``vectorized=True`` and no rotating
            frame.
        time: evaluation time for the (constant) generator.
        check_residual: relative nullspace-residual tolerance above which
            the result is NaN-poisoned (``None`` disables). Degenerate
            steady-state manifolds return the trace-bordered projection.

    Returns:
        ``(dim, dim)`` density matrix, Hermitized and trace-normalized.
    """
    _validate_steady_model(model)
    L = model.evaluate(time)
    return _steady_from_superop(jnp.asarray(L), check_residual)


def lindblad_steady_state_iterative(
    model,
    time: float = 0.0,
    tol: float = 1e-8,
    maxiter: Optional[int] = 2000,
    restart: int = 200,
    check_residual: Optional[float] = 1e-6,
):
    r"""Matrix-free steady state for large dimensions (dim :math:`\gtrsim` 32).

    Solves the trace-bordered system

    .. math:: \left(\mathcal{L} + v\, \langle v, \cdot\rangle\right) x = v,
              \qquad v = I/\sqrt{n}

    with GMRES, where every :math:`\mathcal{L}` ACTION is the model's
    matrix-form RHS evaluation (``model(t, rho)`` — :math:`O(k\, n^3)` per
    apply through the dense or BCOO collection) and the Hilbert-Schmidt
    inner product supplies the border. For an irreducible Lindbladian the
    bordered operator is nonsingular (``v`` spans the left kernel — trace
    preservation — and the border restores it to the range), and the unique
    solution is the trace-normalized steady state. The
    :math:`(n^2, n^2)` superoperator is NEVER materialized — a dim-32
    chain solves without forming the 1024x1024 matrix, and memory stays
    :math:`O(\text{restart}\; n^2)` (the Krylov basis).

    Args:
        model: ``LindbladModel`` with ``vectorized=False`` (the matrix-apply
            form; dense or sparse array library — not ``scipy_sparse``,
            which cannot run under the solver's jit) and no rotating frame.
        time: evaluation time for the (constant) generator.
        tol: GMRES relative tolerance.
        maxiter: GMRES outer-iteration cap.
        restart: GMRES restart length (Krylov memory,
            ``O(restart * n^2)``). Driven Lindbladians are highly
            non-normal and RESTARTED GMRES stagnates on them (measured: a
            dim-32 driven chain stalls at 3.6e-2 residual with restart=40
            but converges to 1e-11 with restart=200) — raise ``restart``
            before ``maxiter`` if the residual check poisons the result.
        check_residual: relative residual above which the result is
            NaN-poisoned (package convention: no raises under trace).

    Returns:
        ``(dim, dim)`` density matrix, Hermitized and trace-normalized.
    """
    from jax.scipy.sparse.linalg import gmres

    from ..models import LindbladModel

    if not isinstance(model, LindbladModel) or model.vectorized:
        raise DynamicsError(
            "lindblad_steady_state_iterative requires a LindbladModel with "
            "vectorized=False (the matrix-apply form); use "
            "lindblad_steady_state for vectorized models at small dim."
        )
    if model._rotating_frame.frame_diag is not None:
        raise DynamicsError(
            "lindblad_steady_state_iterative requires rotating_frame=None "
            "(a static steady state is frame-dependent otherwise)."
        )
    n = model.dim
    v = jnp.eye(n, dtype=complex) / np.sqrt(n)

    def bordered(rho):
        inner = jnp.sum(jnp.conj(v) * rho)  # Hilbert-Schmidt <v, rho>
        return model(time, rho) + v * inner

    x, _ = gmres(
        bordered, v, x0=v, tol=tol, atol=0.0, maxiter=maxiter,
        restart=restart, solve_method="batched",
    )
    if check_residual is not None:
        res = jnp.linalg.norm(model(time, x)) / jnp.linalg.norm(x)
        x = jnp.where(res <= check_residual, x, jnp.full_like(x, jnp.nan))
    rho = 0.5 * (x + jnp.conj(x.T))
    return rho / jnp.trace(rho)


def lindblad_steady_state_sweep(
    model,
    hamiltonian_values=None,
    dissipator_values=None,
    check_residual: Optional[float] = 1e-6,
):
    r"""Batched steady states over a sweep of constant signal values.

    The Lindblad generator is linear in the Hamiltonian signal values and
    dissipator rates, so the whole sweep assembles as one tensor
    contraction over precomputed basis superoperators and solves as one
    batched Hermitian system (differentiable w.r.t. the
    values).

    Args:
        model: ``LindbladModel`` with ``vectorized=True``, no rotating
            frame.
        hamiltonian_values: ``(B, k_h)`` constant Hamiltonian signal
            values (or ``None`` if the model has no Hamiltonian operators).
        dissipator_values: ``(B, k_d)`` dissipator rates (or ``None``).
        check_residual: see :func:`lindblad_steady_state`.

    Returns:
        ``(B, dim, dim)`` density matrices.
    """
    _validate_steady_model(model)
    coll = model._operator_collection

    k_h = 0 if model.hamiltonian_operators is None else len(model.hamiltonian_operators)
    k_d = 0 if model.dissipator_operators is None else len(model.dissipator_operators)
    if (hamiltonian_values is None) != (k_h == 0):
        raise DynamicsError(
            f"hamiltonian_values must match the model's {k_h} Hamiltonian operators."
        )
    if (dissipator_values is None) != (k_d == 0):
        raise DynamicsError(
            f"dissipator_values must match the model's {k_d} dissipator operators."
        )

    zeros_h = jnp.zeros(k_h) if k_h else None
    zeros_d = jnp.zeros(k_d) if k_d else None
    L0 = jnp.asarray(coll.evaluate(zeros_h, zeros_d))
    basis = []
    values = []
    if k_h:
        hamiltonian_values = jnp.asarray(hamiltonian_values)
        for j in range(k_h):
            e = jnp.zeros(k_h).at[j].set(1.0)
            basis.append(jnp.asarray(coll.evaluate(e, zeros_d)) - L0)
        values.append(hamiltonian_values)
    if k_d:
        dissipator_values = jnp.asarray(dissipator_values)
        for j in range(k_d):
            e = jnp.zeros(k_d).at[j].set(1.0)
            basis.append(jnp.asarray(coll.evaluate(zeros_h, e)) - L0)
        values.append(dissipator_values)
    Ls = L0
    if basis:
        stacked = jnp.stack(basis)  # (k, n2, n2)
        coeffs = jnp.concatenate(values, axis=-1)  # (B, k)
        Ls = L0[None] + jnp.tensordot(coeffs, stacked, axes=1)
    return _steady_from_superop(Ls, check_residual)


class FloquetResult(NamedTuple):
    """Floquet analysis of a time-periodic generator.

    Attributes:
        quasienergies: ``(dim,)`` quasienergies in ``(-pi/T, pi/T]``.
        decay_rates: ``(dim,)`` per-mode decay rates ``-log|lambda|/T``
            (zero for unitary dynamics up to solver error).
        modes: ``(dim, dim)`` Floquet modes at ``t0`` (columns).
        propagator: the one-period propagator ``U(t0 + T, t0)``.
    """

    quasienergies: np.ndarray
    decay_rates: np.ndarray
    modes: np.ndarray
    propagator: np.ndarray


def floquet_basis(
    model, T: float, t0: float = 0.0, method: str = "tpu_dopri5", **kwargs
) -> FloquetResult:
    r"""Floquet quasienergies and modes of a T-periodic generator.

    Solves the one-period propagator :math:`U(t_0+T, t_0)` on device with
    any ``solve_lmde`` method, then eigendecomposes host-side (general
    ``eig`` runs only on the host; ``dim`` is small once the propagator is
    in hand): :math:`U u_j = e^{-i \epsilon_j T} u_j` with quasienergies
    folded to the first Brillouin zone :math:`(-\pi/T, \pi/T]`.

    The model's signals must be ``T``-periodic over ``[t0, t0 + T]`` —
    this is the caller's contract (it cannot be checked cheaply). If the
    model carries a rotating frame, the analysis applies to the generator
    *in that frame*; use a frame whose phases are themselves ``T``-periodic
    (or no frame) for lab-frame quasienergies.

    Args:
        model: a generator model (Hamiltonian/Generator, or vectorized
            Lindblad — then the ``propagator`` is the superoperator
            one-period map and ``decay_rates`` carry the physics).
        T: drive period.
        t0: period start.
        method: any ``solve_lmde`` method.
        kwargs: forwarded to ``solve_lmde`` (tolerances etc.).

    Returns:
        :class:`FloquetResult`.
    """
    from .solver_functions import solve_lmde

    if T <= 0:
        raise DynamicsError("floquet_basis requires a positive period T.")
    dim = model.dim * model.dim if getattr(model, "vectorized", False) else model.dim
    y0 = np.eye(dim, dtype=complex)
    result = solve_lmde(model, t_span=[t0, t0 + T], y0=y0, method=method, **kwargs)
    U = np.asarray(result.y[-1])
    evals, modes = np.linalg.eig(U)
    quasi = -np.angle(evals) / T
    rates = -np.log(np.clip(np.abs(evals), 1e-300, None)) / T
    order = np.argsort(quasi)
    return FloquetResult(
        quasienergies=quasi[order],
        decay_rates=rates[order],
        modes=modes[:, order],
        propagator=U,
    )


def correlation_function(
    model,
    a_op,
    b_op,
    taus,
    rho0=None,
    method: str = "tpu_dopri5",
    **kwargs,
):
    r"""Two-time correlation :math:`C(\tau) = \langle A(\tau) B(0) \rangle`.

    Quantum regression theorem for a time-independent Lindbladian:
    :math:`C(\tau) = \mathrm{Tr}\!\left[A\, e^{\mathcal{L}\tau}(B\rho)\right]`
    — one device solve of the vectorized model with initial state
    :math:`\mathrm{vec}(B\rho)` over the ``taus`` grid, then a trace
    contraction per time.

    Args:
        model: ``LindbladModel`` with ``vectorized=True``, no rotating
            frame, constant signals (the regression theorem needs a
            time-independent generator).
        a_op: ``(dim, dim)`` operator measured at :math:`\tau`.
        b_op: ``(dim, dim)`` operator applied at time 0.
        taus: increasing correlation times starting at 0 (or any
            ``t_span``-compatible grid).
        rho0: initial density matrix; defaults to the steady state.
        method: any ``solve_lmde`` method.
        kwargs: forwarded to ``solve_lmde``.

    Returns:
        ``(len(taus),)`` complex correlation values.
    """
    from .solver_functions import solve_lmde

    _validate_steady_model(model, allow_non_vectorized=True)
    if rho0 is None:
        rho0 = (
            lindblad_steady_state(model)
            if model.vectorized
            else lindblad_steady_state_iterative(model)
        )
    a_op = jnp.asarray(a_op)
    b_op = jnp.asarray(b_op)
    taus = np.asarray(taus)
    if model.vectorized:
        y0 = _vec_col(b_op @ jnp.asarray(rho0))
    else:
        # matrix-apply evolution: same semigroup, O(k n^3) per RHS instead
        # of O(n^4) — the large-dim path (dim >~ 32)
        y0 = b_op @ jnp.asarray(rho0)
    result = solve_lmde(
        model, t_span=[float(taus[0]), float(taus[-1])], y0=y0,
        t_eval=taus, method=method, **kwargs
    )
    if model.vectorized:
        states = jnp.asarray(result.y)  # (T, dim^2) vec-col states
        return states @ _trace_weights(a_op)
    # Tr[A M_t] per time
    return jnp.einsum("ij,tji->t", a_op, jnp.asarray(result.y))


def spectrum(model, a_op, b_op, frequencies, rho0=None):
    r"""Emission/absorption spectrum — the one-sided Fourier transform of
    :math:`C(\tau) = \langle A(\tau) B(0)\rangle` in closed form:

    .. math:: S(\omega)
        = 2\,\mathrm{Re}\,\int_0^\infty C(\tau) e^{i\omega\tau}\, d\tau
        = -2\,\mathrm{Re}\,\mathrm{Tr}\!\left[
            A\, (i\omega + \mathcal{L})^{-1} (B \rho_{ss})\right],

    Convention: one-sided transform with kernel :math:`e^{i\omega\tau}`,
    so a coherence decaying as :math:`e^{-i\omega_0\tau - \gamma\tau/2}`
    produces a Lorentzian of HWHM :math:`\gamma/2` peaked at
    :math:`\omega = \omega_0`. Every frequency is one right-hand
    side of a batched linear solve — no time integration, no FFT leakage,
    differentiable w.r.t. model values upstream.

    Args:
        model: ``LindbladModel`` with ``vectorized=True``, no rotating
            frame, constant signals.
        a_op: ``(dim, dim)`` operator (e.g. :math:`\sigma_-`).
        b_op: ``(dim, dim)`` operator (e.g. :math:`\sigma_+`).
        frequencies: ``(W,)`` angular frequencies.
        rho0: density matrix at time 0; defaults to the steady state.

    Returns:
        ``(W,)`` real spectrum values — the INCOHERENT part: the elastic
        delta-peak at ``w = 0`` (weight ``Tr[A rho_ss] Tr[B rho0]``) is
        omitted, as is standard.
    """
    _validate_steady_model(model)
    if rho0 is None:
        rho0 = lindblad_steady_state(model)
    L = jnp.asarray(model.evaluate(0.0))
    n2 = L.shape[-1]
    n = int(round(np.sqrt(n2)))
    freqs = jnp.asarray(frequencies, dtype=float)
    y = _vec_col(jnp.asarray(b_op) @ jnp.asarray(rho0))
    # L is singular (steady-state zero mode: right null vec(rho_ss), left
    # null vec(I) by trace preservation). C(tau) -> Tr[A rho_ss] Tr[B rho0]
    # as tau -> inf; that elastic part transforms to a delta at w = 0 and is
    # OMITTED here (this is the incoherent spectrum). Subtract the
    # stationary component of the RHS — a no-op for w != 0 since the
    # dropped term's transform is purely imaginary — and shift the zero
    # mode with its spectral projector vec(rho_ss) vec(I)^H, which acts
    # only on the stationary block, so every system is nonsingular.
    rho_ss_vec = _vec_col(jnp.asarray(lindblad_steady_state(model)))
    w_tr = jnp.eye(n, dtype=L.dtype).reshape(-1)  # vec(I) trace functional
    y_red = y - rho_ss_vec * (w_tr @ y)
    L_shift = L + rho_ss_vec[:, None] * w_tr[None, :]
    # (W, n2, n2) batched resolvent systems (i w + L_shift) x = y_red
    A = 1j * freqs[:, None, None] * jnp.eye(n2, dtype=L.dtype)[None] + L_shift[None]
    x = jnp.linalg.solve(
        A, jnp.broadcast_to(y_red, (freqs.shape[0], n2))[..., None]
    )[..., 0]
    c_hat = x @ _trace_weights(jnp.asarray(a_op))
    return -2.0 * jnp.real(c_hat)


def spectrum_iterative(
    model,
    a_op,
    b_op,
    frequencies,
    rho0=None,
    tol: float = 1e-8,
    maxiter: Optional[int] = 2000,
    restart: int = 200,
):
    r"""Matrix-free :func:`spectrum` for large dimensions (dim
    :math:`\gtrsim` 32).

    Same quantity and conventions as :func:`spectrum` (incoherent one-sided
    transform, elastic delta omitted), but each frequency's resolvent system
    :math:`(i\omega + \mathcal{L} + P)\,x = y_\mathrm{red}` is solved with
    GMRES where every :math:`\mathcal{L}` ACTION is the model's matrix-form
    RHS (``model(0, X)`` — :math:`O(k\,n^3)` per apply) and the zero-mode
    shift :math:`P = \mathrm{vec}(\rho_{ss})\mathrm{vec}(I)^H` acts as
    ``rho_ss * Tr[X]``. The :math:`(n^2, n^2)` superoperator is never
    materialized; frequencies run sequentially through ``lax.map`` so memory
    stays :math:`O(\text{restart}\,n^2)`.

    Args:
        model: ``LindbladModel`` with ``vectorized=False``, no rotating
            frame, constant signals.
        a_op: ``(dim, dim)`` operator measured at :math:`\tau`.
        b_op: ``(dim, dim)`` operator applied at time 0.
        frequencies: ``(W,)`` angular frequencies.
        rho0: density matrix at time 0; defaults to the steady state
            (computed via :func:`lindblad_steady_state_iterative`).
        tol: GMRES relative tolerance per frequency.
        maxiter: GMRES outer-iteration cap.
        restart: GMRES restart length (see
            :func:`lindblad_steady_state_iterative` — driven Lindbladians
            need generous restarts).

    Returns:
        ``(W,)`` real spectrum values.
    """
    from jax.scipy.sparse.linalg import gmres

    from ..models import LindbladModel

    if not isinstance(model, LindbladModel) or model.vectorized:
        raise DynamicsError(
            "spectrum_iterative requires a LindbladModel with "
            "vectorized=False (the matrix-apply form); use spectrum for "
            "vectorized models at small dim."
        )
    if model._rotating_frame.frame_diag is not None:
        raise DynamicsError("spectrum_iterative requires rotating_frame=None.")

    rho_ss = lindblad_steady_state_iterative(
        model, tol=tol, maxiter=maxiter, restart=restart
    )
    if rho0 is None:
        rho0 = rho_ss
    a_op = jnp.asarray(a_op)
    b_op = jnp.asarray(b_op)
    freqs = jnp.asarray(frequencies, dtype=float)

    Y = b_op @ jnp.asarray(rho0)
    # remove the stationary component (elastic part; delta at w = 0 omitted)
    Y_red = Y - rho_ss * jnp.trace(Y)

    def solve_one(w):
        def shifted(X):
            return 1j * w * X + model(0.0, X) + rho_ss * jnp.trace(X)

        X, _ = gmres(
            shifted, Y_red, x0=Y_red, tol=tol, atol=0.0, maxiter=maxiter,
            restart=restart, solve_method="batched",
        )
        return jnp.einsum("ij,ji->", a_op, X)

    c_hat = jax.lax.map(solve_one, freqs)
    return -2.0 * jnp.real(c_hat)
