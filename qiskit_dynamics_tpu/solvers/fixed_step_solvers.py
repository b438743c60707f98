"""Fixed-step solvers: RK4, matrix-exponential (Magnus 1/2/3), Lanczos, and
log-depth parallel propagator chains.

Reference: ``/root/reference/qiskit_dynamics/solvers/fixed_step_solvers.py``.
The accelerator payoff lives in the ``*_parallel`` variants: per-step
propagators are computed batched with ``vmap`` (batched expm / RK4) and
chained with ``jax.lax.associative_scan`` — a log-depth matmul tree.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple
from warnings import warn

import numpy as np
import jax
import jax.numpy as jnp
from jax import vmap
from jax.lax import scan, cond, associative_scan
from jax.scipy.linalg import expm as jexpm
from scipy.linalg import expm as scipy_expm

from ..exceptions import DynamicsError
from ..ops.expm import expm_taylor
from .results import OdeResult
from .solver_utils import merge_t_args, trim_t_results
from .lanczos import lanczos_expm, jax_lanczos_expm

__all__ = [
    "RK4_solver",
    "jax_RK4_solver",
    "scipy_expm_solver",
    "jax_expm_solver",
    "lanczos_diag_solver",
    "jax_lanczos_diag_solver",
    "jax_expm_parallel_solver",
    "jax_RK4_parallel_solver",
    "get_fixed_step_sizes",
    "get_exponential_take_step",
]


def _rk4_take_step(rhs_func, t, y, h):
    h2 = 0.5 * h
    t2 = t + h2
    k1 = rhs_func(t, y)
    k2 = rhs_func(t2, y + h2 * k1)
    k3 = rhs_func(t2, y + h2 * k2)
    k4 = rhs_func(t + h, y + h * k3)
    return y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def RK4_solver(rhs, t_span, y0, max_dt, t_eval=None):
    """Fixed-step 4th-order Runge-Kutta (host loop)."""
    return fixed_step_solver_template(
        _rk4_take_step, rhs_func=rhs, t_span=t_span, y0=y0, max_dt=max_dt, t_eval=t_eval
    )


def jax_RK4_solver(rhs, t_span, y0, max_dt, t_eval=None):
    """Fixed-step RK4 under ``lax.scan``."""
    return fixed_step_solver_template_jax(
        _rk4_take_step, rhs_func=rhs, t_span=t_span, y0=y0, max_dt=max_dt, t_eval=t_eval
    )


def _dense_scipy_expm(a):
    """``scipy.linalg.expm`` is dense-only; densify sparse step generators
    (the propagator is dense regardless, so nothing is lost)."""
    if hasattr(a, "toarray"):
        a = a.toarray()
    return scipy_expm(a)


def scipy_expm_solver(generator, t_span, y0, max_dt, t_eval=None, magnus_order: int = 1):
    """Fixed-step matrix-exponential solver via ``scipy.linalg.expm``."""
    take_step = get_exponential_take_step(magnus_order, expm_func=_dense_scipy_expm)
    return fixed_step_solver_template(
        take_step, rhs_func=generator, t_span=t_span, y0=y0, max_dt=max_dt, t_eval=t_eval
    )


def _select_expm(expm_method: str, expm_order: int, expm_squarings: int):
    """Pick the expm kernel: 'pade' = jax.scipy (norm-adaptive, branching),
    'taylor' = branch-free fixed-order scaling-and-squaring (ops/expm.py) —
    the fast path for fixed-step solvers whose step norm is bounded."""
    if expm_method == "taylor":
        return lambda a: expm_taylor(a, order=expm_order, squarings=expm_squarings)
    if expm_method == "pade":
        return jexpm
    raise DynamicsError(f"expm_method {expm_method} not supported (use 'pade' or 'taylor').")


def jax_expm_solver(
    generator,
    t_span,
    y0,
    max_dt,
    t_eval=None,
    magnus_order: int = 1,
    expm_method: str = "pade",
    expm_order: int = 12,
    expm_squarings: int = 2,
):
    """Fixed-step matrix-exponential solver (jax)."""
    expm_func = _select_expm(expm_method, expm_order, expm_squarings)
    take_step = get_exponential_take_step(magnus_order, expm_func=expm_func)
    return fixed_step_solver_template_jax(
        take_step, rhs_func=generator, t_span=t_span, y0=jnp.asarray(y0, dtype=complex),
        max_dt=max_dt, t_eval=t_eval,
    )


def lanczos_diag_solver(generator, t_span, y0, max_dt, k_dim, t_eval=None):
    """Fixed-step Krylov (Lanczos) expm-action solver (numpy)."""

    def take_step(gen, t0, y, h):
        return lanczos_expm(gen(t0 + h / 2), y, k_dim, h)

    return fixed_step_solver_template(
        take_step, rhs_func=generator, t_span=t_span, y0=y0, max_dt=max_dt, t_eval=t_eval
    )


def jax_lanczos_diag_solver(generator, t_span, y0, max_dt, k_dim, t_eval=None):
    """Fixed-step Krylov (Lanczos) expm-action solver (JAX)."""

    def take_step(gen, t0, y, h):
        return jax_lanczos_expm(gen(t0 + h / 2), y, k_dim, h)

    return fixed_step_solver_template_jax(
        take_step, rhs_func=generator, t_span=t_span, y0=jnp.asarray(y0, dtype=complex),
        max_dt=max_dt, t_eval=t_eval,
    )


def jax_expm_parallel_solver(
    generator,
    t_span,
    y0,
    max_dt,
    t_eval=None,
    magnus_order: int = 1,
    expm_method: str = "pade",
    expm_order: int = 12,
    expm_squarings: int = 2,
):
    """Parallel expm solver: batched per-step propagators + associative scan."""
    expm_func = _select_expm(expm_method, expm_order, expm_squarings)
    take_step = get_exponential_take_step(magnus_order, expm_func=expm_func, just_propagator=True)
    return fixed_step_lmde_solver_parallel_template_jax(
        take_step, generator=generator, t_span=t_span, y0=y0, max_dt=max_dt, t_eval=t_eval
    )


def jax_RK4_parallel_solver(generator, t_span, y0, max_dt, t_eval=None):
    """Parallel RK4 solver for LMDEs: per-step RK4 propagators + associative scan."""
    dim = y0.shape[-1]
    ident = jnp.eye(dim, dtype=complex)

    def take_step(gen, t, h):
        h2 = 0.5 * h
        gh2 = gen(t + h2)
        k1 = gen(t)
        k2 = gh2 @ (ident + h2 * k1)
        k3 = gh2 @ (ident + h2 * k2)
        k4 = gen(t + h) @ (ident + h * k3)
        return ident + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    return fixed_step_lmde_solver_parallel_template_jax(
        take_step, generator=generator, t_span=t_span, y0=y0, max_dt=max_dt, t_eval=t_eval
    )


def _matrix_commutator(m1, m2):
    return m1 @ m2 - m2 @ m1


def get_exponential_take_step(magnus_order: int, expm_func: Callable, just_propagator=False):
    """Single-step propagator rules for Magnus orders 1-3.

    Gauss-point generator samples and commutator corrections per Blanes et al.,
    "The Magnus expansion and some of its applications" (2009). Order 1 is the
    midpoint-exponential rule ``expm(G(t+h/2) h)``.
    """
    if magnus_order == 1:

        def propagator(generator, t0, h):
            return expm_func(generator(t0 + h / 2) * h)

    elif magnus_order == 2:
        c1 = 0.5 - np.sqrt(3) / 6
        c2 = 0.5 + np.sqrt(3) / 6
        p2 = np.sqrt(3) / 12

        def propagator(generator, t0, h):
            g1 = generator(t0 + c1 * h)
            g2 = generator(t0 + c2 * h)
            terms = h * (g1 + g2) / 2 + p2 * (h**2) * _matrix_commutator(g2, g1)
            return expm_func(terms)

    elif magnus_order == 3:
        d1 = 0.5 - np.sqrt(15) / 10
        d2 = 0.5
        d3 = 0.5 + np.sqrt(15) / 10
        c0 = np.sqrt(15) / 3
        c1 = 10.0 / 3

        def propagator(generator, t0, h):
            g1 = generator(t0 + d1 * h)
            g2 = generator(t0 + d2 * h)
            g3 = generator(t0 + d3 * h)
            a1 = h * g2
            a2 = c0 * h * (g3 - g1)
            a3 = c1 * h * (g3 - 2 * g2 + g1)
            comm1 = _matrix_commutator(a1, a2)
            comm2 = _matrix_commutator(2 * a3 + comm1, a1) / 60
            terms = a1 + (a3 / 12) + _matrix_commutator(-20 * a1 - a3 + comm1, a2 + comm2) / 240
            return expm_func(terms)

    else:
        raise DynamicsError("Only magnus_order 1, 2, and 3 are supported.")

    if just_propagator:
        return propagator

    def take_step(generator, t0, y, h):
        return propagator(generator, t0, h) @ y

    return take_step


def fixed_step_solver_template(take_step, rhs_func, t_span, y0, max_dt, t_eval=None):
    """Host-loop fixed-step template: subdivide each interval into <= max_dt steps."""
    y0 = np.asarray(y0)
    t_list, h_list, n_steps_list = get_fixed_step_sizes(t_span, t_eval, max_dt)

    ys = [y0]
    for current_t, h, n_steps in zip(t_list, h_list, n_steps_list):
        y = ys[-1]
        inner_t = current_t
        for _ in range(int(n_steps)):
            y = take_step(rhs_func, inner_t, y, h)
            inner_t = inner_t + h
        ys.append(y)
    results = OdeResult(t=t_list, y=np.asarray(ys))
    return trim_t_results(results, t_eval)


def fixed_step_solver_template_jax(take_step, rhs_func, t_span, y0, max_dt, t_eval=None):
    """``lax.scan`` fixed-step template with ``cond``-masked inner steps."""
    y0 = jnp.asarray(y0)
    t_list, h_list, n_steps_list = get_fixed_step_sizes(t_span, t_eval, max_dt)
    max_steps = int(n_steps_list.max())

    def scan_interval(carry, x):
        current_t, h, n_steps = x
        current_y = carry

        def scan_take_step(step_carry, step):
            t, y = step_carry
            y = cond(step < n_steps, lambda yy: take_step(rhs_func, t, yy, h), lambda yy: yy, y)
            return (t + h, y), None

        next_y = scan(scan_take_step, (current_t, current_y), jnp.arange(max_steps))[0][1]
        return next_y, next_y

    ys = scan(
        scan_interval,
        init=y0,
        xs=(jnp.asarray(t_list[:-1]), jnp.asarray(h_list), jnp.asarray(n_steps_list)),
    )[1]
    ys = jnp.concatenate([y0[None], ys], axis=0)
    results = OdeResult(t=t_list, y=ys)
    return trim_t_results(results, t_eval)


def fixed_step_lmde_solver_parallel_template_jax(
    take_step, generator, t_span, y0, max_dt, t_eval=None
):
    """Parallel fixed-step LMDE template.

    Computes every per-step propagator batched via ``vmap`` (one batched expm /
    matmul chain) and composes them with a log-depth
    ``associative_scan`` (reverse matmul).
    """
    if jax.default_backend() == "cpu":
        warn(
            "Parallel solvers will likely run slower on CPUs than non-parallel solvers. "
            "To make use of their capabilities use a GPU.",
            stacklevel=2,
        )

    y0 = jnp.asarray(y0)
    t_list, h_list, n_steps_list = get_fixed_step_sizes(t_span, t_eval, max_dt)

    all_times = []
    all_h = []
    t_list_locations = [0]
    for t, h, n_steps in zip(t_list, h_list, n_steps_list):
        all_times = np.append(all_times, t + h * np.arange(n_steps))
        all_h = np.append(all_h, h * np.ones(n_steps))
        t_list_locations = np.append(t_list_locations, [t_list_locations[-1] + n_steps])

    step_propagators = vmap(lambda t, h: take_step(generator, t, h))(
        jnp.asarray(all_times), jnp.asarray(all_h)
    )

    def reverse_mul(A, B):
        return jnp.matmul(B, A)

    if y0.ndim == 2 and y0.shape[0] == y0.shape[1]:
        intermediate_props = associative_scan(
            reverse_mul, jnp.concatenate([y0[None].astype(step_propagators.dtype),
                                          step_propagators], axis=0), axis=0
        )
        ys = intermediate_props[t_list_locations]
    else:
        intermediate_props = associative_scan(reverse_mul, step_propagators, axis=0)
        intermediate_y = intermediate_props[t_list_locations[1:] - 1] @ y0
        ys = jnp.concatenate([y0[None].astype(intermediate_y.dtype), intermediate_y], axis=0)

    results = OdeResult(t=t_list, y=ys)
    return trim_t_results(results, t_eval)


def get_fixed_step_sizes(t_span, t_eval, max_dt: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge times and compute per-interval step sizes <= max_dt."""
    t_span = np.asarray(t_span)
    max_dt = np.asarray(max_dt)
    t_list = np.asarray(merge_t_args(t_span, t_eval))

    delta_t_list = np.diff(t_list)
    n_steps_list = np.abs(delta_t_list / max_dt).astype(int)
    for idx, (delta_t, n_steps) in enumerate(zip(delta_t_list, n_steps_list)):
        if n_steps == 0:
            n_steps_list[idx] = 1
        elif np.abs(delta_t / n_steps) / max_dt > 1 + 1e-15:
            n_steps_list[idx] = n_steps + 1

    h_list = np.asarray(delta_t_list / n_steps_list)
    return t_list, h_list, n_steps_list
