r"""Chebyshev-interpolated parameter sweeps: 1e-8-class sweeps at fused speed.

The headline sweep workload — a calibration curve over ONE scalar parameter
(drive amplitude, gate time, detuning) — has structure every per-point solver
ignores: the final state ``y_f(p)`` of a linear ODE whose generator depends
analytically on ``p`` is an ENTIRE function of ``p`` (a parameterized linear
ODE has an everywhere-convergent parameter expansion). Its Chebyshev
interpolant on the sweep interval therefore converges super-geometrically: a
few dozen solved nodes reconstruct tens of thousands of sweep points to
1e-9-class accuracy.

This module exploits that: solve the model at ``M`` Chebyshev-Lobatto nodes
with a HIGH-PRECISION inner solver (default: the compensated double-float32
fixed-step engine, ``fused_sweep_solve(precision="df32")`` — ~1e-9 per-point
in float32 arithmetic), then evaluate the interpolant at all ``B`` sweep points with one
host-f64 matmul. Refinement is adaptive and CERTIFIED a posteriori: Lobatto
node sets nest under doubling (``cos(j pi / N)`` for ``N -> 2N`` keeps every
old node), so each refinement level solves only the new (odd-index) nodes and
checks them against the PREVIOUS level's interpolant — the reported error
estimate is a direct solver-vs-interpolant comparison at held-out points, not
a heuristic.

Scope and honesty:

- This is a SWEEP-LEVEL algorithm: per-point cost claims don't apply — the
  win is real only when ``B >> M``. The benchmark rows that use it say so.
- The accuracy floor is the inner solver's accuracy plus the certified
  interpolation error.
- Requires the solution to be smooth in the swept scalar. Analyticity holds
  for any parameter entering the generator or signals smoothly (amplitudes,
  phases, frequencies, durations-via-scaling); piecewise definitions of
  ``signals_fn`` in ``p`` (e.g. ``if p > 0.5``) break it — the a posteriori
  check then fails loudly rather than returning garbage.

The reference has no analog (its only sweep interface is a serial Python
loop, ``/root/reference/qiskit_dynamics/solvers/solver_classes.py:569-586``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import jax

from ..exceptions import DynamicsError

__all__ = [
    "interpolated_sweep_solve",
    "interpolated_sweep_solve_2d",
    "SweepInterpolationInfo",
    "SweepInterpolation2DInfo",
]


class SweepInterpolationInfo(NamedTuple):
    """Diagnostics of an interpolated sweep solve."""

    n_nodes: int            #: Chebyshev-Lobatto nodes solved in total
    est_error: float        #: certified a posteriori max-abs error estimate
    levels: int             #: refinement levels used (incl. the initial one)
    node_params: np.ndarray  #: the solved node parameter values
    converged: bool         #: whether est_error <= tol was reached


def _lobatto_params(level: int, lo: float, hi: float) -> np.ndarray:
    """All Chebyshev-Lobatto nodes of ``2**level + 1`` points on [lo, hi]."""
    n = 2**level
    x = np.cos(np.pi * np.arange(n + 1) / n)  # [1 ... -1]
    return lo + (hi - lo) * (1.0 - x) / 2.0


def _chebyshev_matrix(params: np.ndarray, lo: float, hi: float, m: int) -> np.ndarray:
    """(B, m) Chebyshev-T Vandermonde of the sweep points on [lo, hi]."""
    x = np.clip(2.0 * (np.asarray(params, dtype=np.float64) - lo) / (hi - lo) - 1.0, -1.0, 1.0)
    return np.polynomial.chebyshev.chebvander(x, m - 1)


def _lobatto_to_cheb_coeffs(values: np.ndarray) -> np.ndarray:
    """Chebyshev coefficients from Lobatto samples (DCT-I, explicit matrix).

    ``values``: (N+1, ...) samples at ``cos(j pi / N)`` — i.e. DESCENDING in
    ``x`` (callers holding ascending-parameter samples pass ``values[::-1]``).
    Returns (N+1, ...) coefficients ``c_m`` with ``f(x) = sum_m c_m T_m(x)``.
    N <= ~512 here, so the O(N^2) cosine matrix beats FFT bookkeeping and is
    exact-structure.
    """
    n = values.shape[0] - 1
    j = np.arange(n + 1)
    cosmat = np.cos(np.pi * np.outer(j, j) / n)  # (m, j)
    w = np.ones(n + 1)
    w[0] = w[-1] = 0.5
    flat = values.reshape(n + 1, -1)
    coef = (2.0 / n) * (cosmat * w[None, :]) @ flat
    coef[0] *= 0.5
    coef[-1] *= 0.5
    return coef.reshape(values.shape)


def interpolated_sweep_solve(
    model,
    signals_fn: Callable,
    params,
    t_span,
    y0,
    tol: float = 1e-8,
    min_level: int = 4,
    max_level: int = 9,
    node_solver: Optional[Callable] = None,
    full_output: bool = False,
    rwa_signal_map: Optional[Callable] = None,
    **solver_kwargs,
):
    r"""Solve a 1-d scalar parameter sweep by adaptive Chebyshev interpolation.

    Args:
        model: as in :func:`~qiskit_dynamics_tpu.solvers.fused_sweep.fused_sweep_solve`.
        signals_fn: maps one SCALAR parameter to the model's signals.
        params: (B,) concrete scalar sweep values (any order, need not be
            uniform). Traced values are rejected — node placement and the
            certification are host-side decisions.
        t_span: ``(t0, tf)``.
        y0: shared initial state.
        tol: target max-abs interpolation error (certified a posteriori at
            each refinement's new nodes). The total error adds the inner
            solver's own accuracy.
        min_level / max_level: refinement bounds; level ``l`` uses
            ``2**l + 1`` Lobatto nodes (nested under doubling). If ``tol``
            is not reached at ``max_level`` a ``DynamicsError`` is raised
            (set ``full_output=True`` semantics don't change this — a
            non-smooth ``signals_fn`` must fail loudly).
        node_solver: optional callable ``(node_params,) -> (M, ...)`` states
            used to solve the nodes. Default: ``fused_sweep_solve`` with
            ``precision="df32"`` (1e-9-class) and ``solver_kwargs``
            forwarded (e.g. ``max_dt``; ``precision="f32"`` picks the fast
            low-precision engine).
        full_output: also return a :class:`SweepInterpolationInfo`.
        rwa_signal_map: forwarded to the default node solver.
        solver_kwargs: forwarded to the default node solver.

    Returns:
        (B, ...) final states (host complex128), or ``(states, info)`` with
        ``full_output=True``.
    """
    leaves = jax.tree_util.tree_leaves(params)
    if any(isinstance(leaf, jax.core.Tracer) for leaf in leaves):
        raise DynamicsError(
            "interpolated_sweep_solve is host-facing: params must be concrete "
            "(node placement and error certification run on host)."
        )
    p = np.asarray(params, dtype=np.float64)
    if p.ndim != 1 or p.size < 2:
        raise DynamicsError(
            "interpolated_sweep_solve sweeps exactly one scalar parameter: "
            f"params must be 1-d with >= 2 entries, got shape {p.shape}."
        )
    lo, hi = float(np.min(p)), float(np.max(p))
    if hi <= lo:
        raise DynamicsError("params must span a nonzero interval.")
    if not 1 <= min_level < max_level:
        raise DynamicsError(
            "need 1 <= min_level < max_level (at least one refinement is "
            "required — the error certificate comes from comparing against "
            "the next level's freshly solved nodes)."
        )

    if node_solver is None:
        from .fused_sweep import fused_sweep_solve

        solver_kwargs.setdefault("precision", "df32")

        def node_solver(node_params):
            return np.asarray(
                fused_sweep_solve(
                    model, signals_fn, node_params, t_span=t_span, y0=y0,
                    rwa_signal_map=rwa_signal_map, **solver_kwargs,
                )
            )

    # ---- level min_level: solve all nodes ----
    level = min_level
    node_p = _lobatto_params(level, lo, hi)
    values = np.asarray(node_solver(node_p))  # (M, ...) states
    est_error = np.inf
    converged = False

    while True:
        coeffs = _lobatto_to_cheb_coeffs(values[::-1])

        if level >= max_level:
            break
        # ---- refine: solve the NEW (odd-index) nodes of the next level and
        # certify the current interpolant against them ----
        next_p = _lobatto_params(level + 1, lo, hi)
        new_p = next_p[1::2]  # odd indices are the new nodes
        new_vals = np.asarray(node_solver(new_p))
        flat_coef = coeffs.reshape(coeffs.shape[0], -1)
        pred = (_chebyshev_matrix(new_p, lo, hi, coeffs.shape[0]) @ flat_coef).reshape(
            new_vals.shape
        )
        est_error = float(np.max(np.abs(pred - new_vals)))

        # merge into the next level's full node set (old values interleave)
        merged = np.empty((next_p.size,) + values.shape[1:], dtype=new_vals.dtype)
        merged[0::2] = values
        merged[1::2] = new_vals
        values, node_p, level = merged, next_p, level + 1

        if est_error <= tol:
            converged = True
            coeffs = _lobatto_to_cheb_coeffs(values[::-1])
            break

    if not converged and est_error > tol:
        raise DynamicsError(
            f"interpolated_sweep_solve did not reach tol={tol:.1e} by "
            f"max_level={max_level} ({node_p.size} nodes): certified error "
            f"estimate {est_error:.2e}. The solution may oscillate faster "
            "than the node budget resolves (raise max_level) or signals_fn "
            "may be non-smooth in the parameter (this method then does not "
            "apply — use a direct per-point sweep)."
        )

    flat_coef = coeffs.reshape(coeffs.shape[0], -1)
    out = (_chebyshev_matrix(p, lo, hi, coeffs.shape[0]) @ flat_coef).reshape(
        (p.size,) + values.shape[1:]
    )
    if full_output:
        info = SweepInterpolationInfo(
            n_nodes=int(node_p.size),
            est_error=float(est_error),
            levels=level - min_level + 1,
            node_params=node_p,
            converged=bool(converged),
        )
        return out, info
    return out


class SweepInterpolation2DInfo(NamedTuple):
    """Diagnostics of a 2-d interpolated sweep solve."""

    n_nodes: int                 #: total node solves across both axes
    est_error: float             #: certified a posteriori max-abs error
    levels: Tuple[int, int]      #: final Lobatto level per axis
    node_params: Tuple[np.ndarray, np.ndarray]  #: node values per axis
    converged: bool              #: whether est_error <= tol was reached


def _cheb_coeffs_2d(values: np.ndarray) -> np.ndarray:
    """Tensor-product Chebyshev coefficients of (N1+1, N2+1, ...) Lobatto
    samples given in ASCENDING parameter order along both axes."""
    c = _lobatto_to_cheb_coeffs(values[::-1])
    c = np.moveaxis(c, 1, 0)
    c = _lobatto_to_cheb_coeffs(c[::-1])
    return np.moveaxis(c, 1, 0)


def _eval_2d(coeffs, x1, x2, lo1, hi1, lo2, hi2, product_grid: bool):
    """Evaluate the tensor interpolant at points (scattered or grid)."""
    m1, m2 = coeffs.shape[0], coeffs.shape[1]
    v1 = _chebyshev_matrix(x1, lo1, hi1, m1)  # (B1, m1)
    v2 = _chebyshev_matrix(x2, lo2, hi2, m2)  # (B2, m2)
    flat = coeffs.reshape(m1, m2, -1)
    if product_grid:
        out = np.einsum("ai,ijs,bj->abs", v1, flat, v2)
        return out.reshape((x1.size, x2.size) + coeffs.shape[2:])
    out = np.einsum("bi,ijs,bj->bs", v1, flat, v2)
    return out.reshape((x1.size,) + coeffs.shape[2:])


def interpolated_sweep_solve_2d(
    model,
    signals_fn: Callable,
    params,
    t_span,
    y0,
    tol: float = 1e-8,
    min_level: int = 3,
    max_level: int = 7,
    node_solver: Optional[Callable] = None,
    full_output: bool = False,
    rwa_signal_map: Optional[Callable] = None,
    **solver_kwargs,
):
    r"""Solve a 2-d scalar-pair sweep by adaptive tensor-Chebyshev interpolation.

    The 2-d analog of :func:`interpolated_sweep_solve` for calibration MAPS
    (e.g. drive amplitude x detuning): the model is solved on a nested
    Chebyshev-Lobatto product grid with the high-precision df32 engine and
    the full sweep is reconstructed through a tensor-product interpolant.
    Refinement is ANISOTROPIC: each round doubles the axis whose Chebyshev
    tail (max |c| over the top half of orders, marginalized over the other
    axis) is larger, so a parameter the solution depends on weakly costs
    almost no extra nodes. Certification is a posteriori as in 1-d: the
    freshly solved nodes of every refinement are compared against the
    PREVIOUS interpolant's prediction before being merged.

    Args:
        model: as in :func:`~.fused_sweep.fused_sweep_solve`.
        signals_fn: maps a ``(p1, p2)`` pair pytree (each leaf scalar or
            batched) to the model's signals — the same callable works for
            per-point fused sweeps over ``(p1_batch, p2_batch)`` pytrees.
        params: either a tuple ``(p1_vals, p2_vals)`` of 1-d arrays — the
            sweep is their PRODUCT grid and the output is
            ``(len(p1), len(p2), ...)`` — or a ``(B, 2)`` array of scattered
            points with output ``(B, ...)``.
        t_span: ``(t0, tf)``.
        y0: shared initial state.
        tol: certified max-abs interpolation error target.
        min_level / max_level: per-axis Lobatto levels (``2**l + 1`` nodes).
        node_solver: optional ``(p1_flat, p2_flat) -> (M, ...)`` override;
            default ``fused_sweep_solve(precision="df32")``.
        full_output: also return :class:`SweepInterpolation2DInfo`.
        rwa_signal_map / solver_kwargs: forwarded to the default node solver.

    Returns:
        States array (see ``params``), or ``(states, info)``.
    """
    leaves = jax.tree_util.tree_leaves(params)
    if any(isinstance(leaf, jax.core.Tracer) for leaf in leaves):
        raise DynamicsError(
            "interpolated_sweep_solve_2d is host-facing: params must be "
            "concrete (node placement and certification run on host)."
        )
    if isinstance(params, tuple) and len(params) == 2:
        p1 = np.asarray(params[0], dtype=np.float64).ravel()
        p2 = np.asarray(params[1], dtype=np.float64).ravel()
        product_grid = True
    else:
        pts = np.asarray(params, dtype=np.float64)
        if pts.ndim != 2 or pts.shape[1] != 2:
            raise DynamicsError(
                "params must be a (p1_vals, p2_vals) tuple (product grid) or "
                f"a (B, 2) array of points; got shape {pts.shape}."
            )
        p1, p2 = pts[:, 0], pts[:, 1]
        product_grid = False
    lo1, hi1 = float(np.min(p1)), float(np.max(p1))
    lo2, hi2 = float(np.min(p2)), float(np.max(p2))
    if hi1 <= lo1 or hi2 <= lo2:
        raise DynamicsError(
            "both parameters must span nonzero intervals; for a 1-d sweep "
            "use interpolated_sweep_solve."
        )
    if not 1 <= min_level < max_level:
        raise DynamicsError("need 1 <= min_level < max_level.")

    if node_solver is None:
        from .fused_sweep import fused_sweep_solve

        solver_kwargs.setdefault("precision", "df32")

        def node_solver(q1, q2):
            return np.asarray(
                fused_sweep_solve(
                    model, signals_fn, (q1, q2), t_span=t_span, y0=y0,
                    rwa_signal_map=rwa_signal_map, **solver_kwargs,
                )
            )

    # ---- initial full product grid ----
    l1 = l2 = min_level
    n1 = _lobatto_params(l1, lo1, hi1)
    n2 = _lobatto_params(l2, lo2, hi2)
    g1, g2 = np.meshgrid(n1, n2, indexing="ij")
    values = np.asarray(node_solver(g1.ravel(), g2.ravel()))
    state_shape = values.shape[1:]
    values = values.reshape((n1.size, n2.size) + state_shape)
    n_nodes = n1.size * n2.size
    est_error = np.inf
    converged = False

    while True:
        coeffs = _cheb_coeffs_2d(values)

        if l1 >= max_level and l2 >= max_level:
            break
        # ---- pick the axis with the larger Chebyshev tail ----
        m1, m2 = coeffs.shape[0], coeffs.shape[1]
        flatc = np.abs(coeffs.reshape(m1, m2, -1))
        tail1 = float(np.max(flatc[m1 // 2:, :, :])) if l1 < max_level else -1.0
        tail2 = float(np.max(flatc[:, m2 // 2:, :])) if l2 < max_level else -1.0
        axis = 0 if tail1 >= tail2 else 1

        if axis == 0:
            next_n = _lobatto_params(l1 + 1, lo1, hi1)
            new_n = next_n[1::2]
            gg1, gg2 = np.meshgrid(new_n, n2, indexing="ij")
        else:
            next_n = _lobatto_params(l2 + 1, lo2, hi2)
            new_n = next_n[1::2]
            gg1, gg2 = np.meshgrid(n1, new_n, indexing="ij")
        new_vals = np.asarray(node_solver(gg1.ravel(), gg2.ravel())).reshape(
            gg1.shape + state_shape
        )
        n_nodes += gg1.size
        pred = _eval_2d(
            coeffs, gg1.ravel(), gg2.ravel(), lo1, hi1, lo2, hi2, False
        ).reshape(new_vals.shape)
        est_error = float(np.max(np.abs(pred - new_vals)))

        # merge (old nodes interleave with new along the refined axis)
        if axis == 0:
            merged = np.empty((next_n.size, n2.size) + state_shape, dtype=new_vals.dtype)
            merged[0::2] = values
            merged[1::2] = new_vals
            values, n1, l1 = merged, next_n, l1 + 1
        else:
            merged = np.empty((n1.size, next_n.size) + state_shape, dtype=new_vals.dtype)
            merged[:, 0::2] = values
            merged[:, 1::2] = new_vals
            values, n2, l2 = merged, next_n, l2 + 1

        if est_error <= tol:
            converged = True
            coeffs = _cheb_coeffs_2d(values)
            break

    if not converged and est_error > tol:
        raise DynamicsError(
            f"interpolated_sweep_solve_2d did not reach tol={tol:.1e} by "
            f"max_level={max_level} per axis ({n1.size}x{n2.size} nodes): "
            f"certified error estimate {est_error:.2e}. Raise max_level or "
            "check that signals_fn is smooth in both parameters."
        )

    # ---- genuinely-2-d certificate: off-node probe points ----
    # The per-refinement certificate samples at the OTHER axis's nodes,
    # where that axis's interpolation is exact by construction — an axis
    # the tail heuristic under-refines would be invisible to it. A final
    # batch of interior points off BOTH node sets closes that hole.
    rng = np.random.default_rng(0)  # deterministic: resume/repro-friendly
    q1 = rng.uniform(lo1, hi1, size=16)
    q2 = rng.uniform(lo2, hi2, size=16)
    probe_vals = np.asarray(node_solver(q1, q2)).reshape((16,) + state_shape)
    n_nodes += 16
    probe_pred = _eval_2d(coeffs, q1, q2, lo1, hi1, lo2, hi2, False).reshape(
        probe_vals.shape
    )
    probe_err = float(np.max(np.abs(probe_pred - probe_vals)))
    est_error = max(est_error, probe_err)
    if probe_err > 10 * tol:  # interpolation error, not inner-solver noise
        raise DynamicsError(
            f"interpolated_sweep_solve_2d: off-node probe certification "
            f"failed ({probe_err:.2e} vs tol={tol:.1e}) after the per-axis "
            "certificates passed — the anisotropic refinement under-resolved "
            "one axis (oscillation aliased below the node density). Raise "
            "min_level or tighten tol."
        )

    out = _eval_2d(coeffs, p1, p2, lo1, hi1, lo2, hi2, product_grid)
    if full_output:
        info = SweepInterpolation2DInfo(
            n_nodes=int(n_nodes),
            est_error=float(est_error),
            levels=(int(l1), int(l2)),
            node_params=(n1, n2),
            converged=bool(converged),
        )
        return out, info
    return out
