r"""Dyson/Magnus perturbative solvers (Dysolve-style fast stepping).

Reference behavior:
``/root/reference/qiskit_dynamics/solvers/perturbative_solvers/*.py``.

Both solvers precompute an :class:`ExpansionModel` at construction, then solve
by per-step polynomial evaluation. The jax stepping path is fully parallel:
every step's propagator is built with one ``vmap``-ed monomial+tensordot
(+ batched ``expm`` for Magnus) and composed with a log-depth
``associative_scan`` — the whole multi-step solve is a handful of large
batched device ops.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, List, Optional, Union

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.linalg import expm as jexpm
from scipy.linalg import expm as scipy_expm

from ...exceptions import DynamicsError
from ...unified import contains_tracer
from ...signals import Signal, SignalList
from ..results import OdeResult
from ..solver_utils import setup_args_lists
from ...parallel.scan import propagator_scan
from .expansion_model import ExpansionModel

__all__ = ["DysonSolver", "MagnusSolver"]


def _nested_ndim(x) -> int:
    if isinstance(x, (list, tuple)):
        return 1 + _nested_ndim(x[0])
    if hasattr(x, "ndim"):
        return x.ndim
    return 0


def _scalar_to_list(x, name):
    ndim = _nested_ndim(x)
    if ndim > 1:
        raise DynamicsError(f"{name} must be either 0d or 1d.")
    if ndim == 1:
        return list(x), True
    return [x], False


def _y0_to_list(y0):
    if isinstance(y0, list):
        return y0, True
    return [y0], False


def _signals_to_list(signals):
    if signals is None:
        return [signals], False
    if isinstance(signals, list) and isinstance(signals[0], (list, SignalList)):
        return signals, True
    if isinstance(signals, SignalList) or (
        isinstance(signals, list) and not isinstance(signals[0], (list, SignalList))
    ):
        return [signals], False
    raise DynamicsError("Signals specified in invalid format.")


def _perturbative_solve(single_step: Callable, model, signals, y0, t0, n_steps):
    """Host-loop stepping."""
    dim = model.Udt.shape[0]
    U0 = np.asarray(model.rotating_frame.state_out_of_frame(t0, np.eye(dim, dtype=complex)))
    Uf = np.asarray(
        model.rotating_frame.state_into_frame(t0 + n_steps * model.dt, np.eye(dim, dtype=complex))
    )
    coeffs = np.asarray(model.approximate_signals(signals, t0, n_steps))
    y = U0 @ np.asarray(y0)
    for k in range(n_steps):
        y = single_step(coeffs[:, k], y)
    return Uf @ y


def _perturbative_solve_jax(single_step: Callable, model, signals, y0, t0, n_steps):
    """Parallel stepping: vmapped per-step propagators + associative scan."""
    dim = model.Udt.shape[0]
    U0 = model.rotating_frame.state_out_of_frame(t0, jnp.eye(dim, dtype=complex))
    Uf = model.rotating_frame.state_into_frame(
        t0 + n_steps * model.dt, jnp.eye(dim, dtype=complex)
    )
    coeffs = model.approximate_signals(signals, t0, n_steps)
    step_propagators = jax.vmap(single_step)(jnp.transpose(jnp.asarray(coeffs)))
    total = propagator_scan(step_propagators)[-1]
    return Uf @ (total @ (U0 @ jnp.asarray(y0)))


class _PerturbativeSolver(ABC):
    """Base class: precomputed model + list-broadcasting ``solve``."""

    def __init__(self, model: ExpansionModel):
        self._model = model

    @property
    def model(self) -> ExpansionModel:
        """Model object storing expansion details."""
        return self._model

    def solve(
        self,
        t0,
        n_steps,
        y0,
        signals,
        jax_control_flow: Optional[bool] = None,
    ) -> Union[OdeResult, List[OdeResult]]:
        """Solve for initial time(s), step count(s), state(s), and signal list(s).

        Any argument may be a list to run a batch of simulations; lists must
        have matching lengths (non-list args are broadcast).
        """
        if jax_control_flow is None:
            jax_control_flow = (
                contains_tracer(y0)
                or isinstance(y0, jax.Array)
                or isinstance(jnp.array(0), jax.core.Tracer)
            )

        args, multiple_sims = setup_args_lists(
            args_list=[t0, n_steps, y0, signals],
            args_names=["t0", "n_steps", "y0", "signals"],
            args_to_list=[
                lambda x: _scalar_to_list(x, "t0"),
                lambda x: _scalar_to_list(x, "n_steps"),
                _y0_to_list,
                _signals_to_list,
            ],
        )

        all_results = []
        for t0_i, n_steps_i, y0_i, signals_i in zip(*args):
            if len(signals_i) != len(self.model.operators):
                raise DynamicsError(
                    "Signals must be the same length as the operators in the model."
                )
            all_results.append(
                self._solve(
                    t0=t0_i,
                    n_steps=n_steps_i,
                    y0=y0_i,
                    signals=signals_i,
                    jax_control_flow=jax_control_flow,
                )
            )
        return all_results if multiple_sims else all_results[0]

    @abstractmethod
    def _solve(self, t0, n_steps, y0, signals, jax_control_flow: bool = False) -> OdeResult:
        ...

    def solve_sweep(
        self,
        t0: float,
        n_steps: int,
        y0,
        signals_fn: Callable,
        params,
        mesh=None,
        expm_squarings: int = 1,
        precision: str = "f32",
        df_order: int = 2,
        df_chunk_b: int = 2048,
        df_devices=None,
    ):
        """Batched parameter-sweep solve through one propagator chain.

        Fast path with no reference counterpart: evaluates the expansion
        polynomial for EVERY (step, sweep member) with one tensordot — for
        Magnus additionally exponentiating every step with the batched
        Taylor :func:`~qiskit_dynamics_tpu.ops.expm.expm_taylor` — then
        applies the per-member propagator chains with one ``lax.scan``
        (:func:`~qiskit_dynamics_tpu.ops.chain_apply.chain_apply`).
        Differentiable end to end by plain autodiff.

        Args:
            t0: shared initial time.
            n_steps: number of steps of size ``model.dt``.
            y0: shared initial state, shape (dim,).
            signals_fn: maps one parameter pytree -> signal list.
            params: batched parameters (dim 0 = sweep axis).
            mesh: optional ``jax.sharding.Mesh`` — shard the sweep batch over
                the mesh's ``"data"`` axis (``parallel.pshard_batch``): each
                device evaluates the expansion polynomial and runs the chain
                on its shard; batches pad to a multiple of the axis size
                (trimmed on return).
            expm_squarings: (Magnus only) scaling-and-squaring count of the
                per-step Taylor-12 ``expm``. In the Dysolve regime the Magnus
                polynomial norm is well below 1, so Taylor-12 converges
                unscaled and every squaring only AMPLIFIES f32 rounding (the
                default 1 keeps a 2x convergence-radius margin). Raise it
                only for ``||Omega * dt|| > 1``.
            precision: ``"f32"`` (default, fastest — accuracy floors at the
                ~3e-6 f32 chain-arithmetic level) or ``"df32"``: the SAME
                truncated expansion in compensated double-float32 with
                host-f64 coefficient tables, reaching the expansion's own
                truncation error (~1e-8 class on the bench config) on chip.
                df32 is host-synchronous (concrete params, numpy-written
                envelopes; not jit/grad-traceable) and returns a host numpy
                array. See :func:`~qiskit_dynamics_tpu.ops.df_chain.dysolve_sweep_df`.
            df_order: (df32 only) highest expansion order kept in df32
                arithmetic; higher orders ride the f32 tail.
            df_chunk_b: (df32 only) member-chunk width per device dispatch.
            df_devices: (df32 only) optional list of ``jax.Device`` — chunk
                dispatches round-robin across them (host-fed multi-device
                data parallelism, as in the df32 sweep engine).

        Returns:
            (B, dim) final states (in the rotating frame of the model, like
            ``solve``).
        """
        if precision == "df32":
            from ...ops.df_chain import dysolve_sweep_df

            if mesh is not None:
                raise DynamicsError(
                    "precision='df32' is host-orchestrated: pass "
                    "df_devices=jax.devices() for multi-device round-robin "
                    "instead of mesh=."
                )
            return dysolve_sweep_df(
                self.model, signals_fn, params, y0, t0, n_steps,
                df_order=df_order, chunk_b=df_chunk_b, devices=df_devices,
            )
        if precision != "f32":
            raise DynamicsError(f"Unknown precision {precision!r} (use 'f32' or 'df32').")

        from ...ops.chain_apply import chain_apply
        from ...ops.expm import expm_taylor

        if mesh is not None:
            from ...parallel.sweep import pshard_batch

            def _local(p):
                return self.solve_sweep(
                    t0, n_steps, y0, signals_fn, p, mesh=None,
                    expm_squarings=expm_squarings,
                )

            return pshard_batch(_local, mesh=mesh)(params)

        model = self.model
        poly = model.expansion_polynomial
        dim = model.Udt.shape[0]

        def coeffs_for(p):
            return jnp.asarray(model.approximate_signals(signals_fn(p), t0, n_steps))

        coeffs = jax.vmap(coeffs_for)(params)          # (B, n_vars, T)
        coeffs = jnp.moveaxis(coeffs, 0, -1)           # (n_vars, T, B)
        monomials = poly.compute_monomials(coeffs)      # (M, T, B)
        props = jnp.tensordot(
            monomials, jnp.asarray(poly.array_coefficients), axes=(0, 0)
        )                                               # (T, B, n, n)
        if poly.constant_term is not None:
            props = props + jnp.asarray(poly.constant_term)

        if model.expansion_method == "magnus":
            # per-step propagator = Udt @ expm(polynomial), one batched
            # Taylor expm over every (step, member)
            props = jnp.asarray(model.Udt) @ expm_taylor(
                props, order=12, squarings=expm_squarings
            )

        U0 = model.rotating_frame.state_out_of_frame(t0, np.eye(dim, dtype=complex))
        Uf = model.rotating_frame.state_into_frame(
            t0 + n_steps * model.dt, np.eye(dim, dtype=complex)
        )
        B = props.shape[1]
        y0_b = jnp.broadcast_to(
            jnp.asarray(U0) @ jnp.asarray(y0, dtype=complex), (B, dim)
        )
        yf = chain_apply(props, y0_b)                   # (B, dim)
        return yf @ jnp.asarray(Uf).T


class DysonSolver(_PerturbativeSolver):
    r"""Fixed-step LMDE solver via a precompiled truncated Dyson series.

    For generators :math:`G(t) = G_0 + \sum_j Re[f_j(t)e^{i2\pi\nu_j t}]G_j`
    with anti-Hermitian :math:`G_0`: solves in the rotating frame of
    :math:`G_0` with step :math:`\Delta t`, approximating each
    frequency-shifted envelope by a Chebyshev interpolant per step and
    evaluating the precomputed multivariable Dyson series polynomial
    (Dysolve; arXiv:2210.11595). ``include_imag`` controls per-signal whether
    the sine (imaginary-envelope) variables are included.
    """

    def __init__(
        self,
        operators,
        rotating_frame,
        dt: float,
        carrier_freqs,
        chebyshev_orders: List[int],
        expansion_order: Optional[int] = None,
        expansion_labels: Optional[List] = None,
        integration_method: Optional[str] = None,
        include_imag: Optional[List[bool]] = None,
        **kwargs,
    ):
        super().__init__(
            ExpansionModel(
                operators=operators,
                rotating_frame=rotating_frame,
                dt=dt,
                carrier_freqs=carrier_freqs,
                chebyshev_orders=chebyshev_orders,
                expansion_method="dyson",
                expansion_order=expansion_order,
                expansion_labels=expansion_labels,
                integration_method=integration_method,
                include_imag=include_imag,
                **kwargs,
            )
        )

    def _solve(self, t0, n_steps, y0, signals, jax_control_flow: bool = False) -> OdeResult:
        if jax_control_flow:
            yf = _perturbative_solve_jax(
                self.model.evaluate, self.model, signals, y0, t0, n_steps
            )
        else:
            def single_step(coeffs, y):
                return self.model.evaluate(coeffs) @ y

            yf = _perturbative_solve(single_step, self.model, signals, y0, t0, n_steps)
        return OdeResult(t=[t0, t0 + n_steps * self.model.dt], y=[y0, yf])


class MagnusSolver(_PerturbativeSolver):
    """Fixed-step LMDE solver via a precompiled truncated Magnus expansion.

    Same structure as :class:`DysonSolver` but per step evaluates
    ``Udt @ expm(polynomial(c))`` — batched ``expm`` over all steps in the jax
    path."""

    def __init__(
        self,
        operators,
        rotating_frame,
        dt: float,
        carrier_freqs,
        chebyshev_orders: List[int],
        expansion_order: Optional[int] = None,
        expansion_labels: Optional[List] = None,
        integration_method: Optional[str] = None,
        include_imag: Optional[List[bool]] = None,
        **kwargs,
    ):
        super().__init__(
            ExpansionModel(
                operators=operators,
                rotating_frame=rotating_frame,
                dt=dt,
                carrier_freqs=carrier_freqs,
                chebyshev_orders=chebyshev_orders,
                expansion_method="magnus",
                expansion_order=expansion_order,
                expansion_labels=expansion_labels,
                integration_method=integration_method,
                include_imag=include_imag,
                **kwargs,
            )
        )

    def _solve(self, t0, n_steps, y0, signals, jax_control_flow: bool = False) -> OdeResult:
        Udt = self.model.Udt
        if jax_control_flow:
            def single_step(coeffs):
                return jnp.asarray(Udt) @ jexpm(self.model.evaluate(coeffs))

            yf = _perturbative_solve_jax(single_step, self.model, signals, y0, t0, n_steps)
        else:
            def single_step(coeffs, y):
                return Udt @ scipy_expm(self.model.evaluate(coeffs)) @ y

            yf = _perturbative_solve(single_step, self.model, signals, y0, t0, n_steps)
        return OdeResult(t=[t0, t0 + n_steps * self.model.dt], y=[y0, yf])
