"""Native adaptive embedded Runge-Kutta solvers under ``jit``.

The reference leans on scipy (host) and ``jax.experimental.ode.odeint`` for
adaptive stepping (``/root/reference/qiskit_dynamics/solvers/solver_functions.py:53-57``).
Here adaptive Dormand-Prince 5(4) (``tpu_dopri5``) and DOP853 (``tpu_dop853``)
are implemented natively as a single bounded ``lax.scan`` with masked
accept/reject steps:

- static shapes and trip count -> compiles once, runs entirely on device;
- reverse-mode differentiable out of the box (scan, not while_loop);
- lands *exactly* on requested output times by clipping steps to the next
  target (no interpolation error);
- backwards integration via time reflection;
- step-budget exhaustion NaN-poisons the output (in-graph error signaling,
  consistent with the framework convention).

Butcher tableaus are taken from scipy's published RK coefficients; step-size
control follows the standard PI-free error-proportional rule with scipy's
safety/min/max factors.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..ops import rk_tableaus as _rk
from .results import OdeResult
from .solver_utils import merge_t_args_jax, trim_t_results_jax

__all__ = ["tpu_dopri5", "tpu_dop853", "tpu_rk_solve"]

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0


class _Tableau:
    def __init__(self, A, B, C, order_exponent, n_stages):
        self.A = np.asarray(A)
        self.B = np.asarray(B)
        self.C = np.asarray(C)
        self.err_exp = order_exponent
        self.n_stages = n_stages


_DOPRI5 = _Tableau(_rk.DOPRI5_A, _rk.DOPRI5_B, _rk.DOPRI5_C, -1.0 / 5.0, _rk.DOPRI5_N_STAGES)
_DOPRI5.E = _rk.DOPRI5_E

_DOP853 = _Tableau(
    _rk.DOP853_A, _rk.DOP853_B, _rk.DOP853_C, -1.0 / 8.0, _rk.DOP853_N_STAGES
)
_DOP853.E5 = _rk.DOP853_E5
_DOP853.E3 = _rk.DOP853_E3


def _cabs(x):
    """|x| via real/imag split.

    Avoids ``abs`` on complex arrays: XLA's algebraic simplifier (as of
    jax 0.9 / CPU PJRT) canonicalizes complex constants like ``[0, 1]`` into a
    complex iota and then miscompiles ``abs(iota)`` (RET_CHECK shape failure
    in ``algebraic_simplifier.cc``). Splitting into real components sidesteps
    the broken rewrite and costs nothing after fusion.
    """
    if jnp.iscomplexobj(x):
        return jnp.sqrt(jnp.real(x) ** 2 + jnp.imag(x) ** 2)
    return jnp.abs(x)


def _rms_norm(x):
    return jnp.sqrt(jnp.mean(_cabs(x) ** 2))


def _dopri5_error_norm(K, h, scale):
    err = h * jnp.tensordot(_DOPRI5.E, K, axes=1)
    return _rms_norm(err / scale)


def _dop853_error_norm(K, h, scale):
    err5 = jnp.tensordot(_DOP853.E5, K, axes=1) / scale
    err3 = jnp.tensordot(_DOP853.E3, K, axes=1) / scale
    err5_norm_2 = jnp.sum(_cabs(err5) ** 2)
    err3_norm_2 = jnp.sum(_cabs(err3) ** 2)
    denom = err5_norm_2 + 0.01 * err3_norm_2
    denom = jnp.where(denom == 0.0, 1.0, denom)
    n = err5.size
    return jnp.abs(h) * err5_norm_2 / jnp.sqrt(denom * n)


def _select_initial_step(f, t0, y0, f0, err_exp, rtol, atol):
    """scipy-style initial step heuristic (two extra RHS evaluations)."""
    import jax as _jax

    y0 = _jax.lax.stop_gradient(y0)
    f0 = _jax.lax.stop_gradient(f0)
    scale = atol + rtol * _cabs(y0)
    d0 = _rms_norm(y0 / scale)
    d1 = _rms_norm(f0 / scale)
    h0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / jnp.where(d1 == 0, 1.0, d1))
    y1 = y0 + h0 * f0
    f1 = _jax.lax.stop_gradient(f(t0 + h0, y1))
    d2 = _rms_norm((f1 - f0) / scale) / h0
    md = jnp.maximum(d1, d2)
    md_safe = jnp.where(md <= 1e-15, 1.0, md)
    h1 = jnp.where(
        md <= 1e-15,
        jnp.maximum(1e-6, h0 * 1e-3),
        (0.01 / md_safe) ** (-err_exp),
    )
    return jnp.minimum(100 * h0, h1)


def _in_trace() -> bool:
    """Whether we are currently inside any JAX trace (jit/grad/vmap/...).

    Uses the core trace-state check so that transforms whose tracers enter
    only through *closures* (``grad`` of a function that builds the RHS from
    the differentiated parameter) are detected too — constant-creation
    probes miss those."""
    try:
        from jax._src.core import trace_state_clean

        return not trace_state_clean()
    except Exception:  # private API moved: fall back to a constant probe
        return isinstance(jnp.zeros(()) + 0, jax.core.Tracer)


@functools.lru_cache(maxsize=64)
def _compiled_rk(rhs, method, rtol, atol, max_steps, first_step, stepper,
                 with_t_eval):
    """Compiled eager-entry solver, cached by (rhs, options).

    Without this cache every eager ``tpu_rk_solve`` call built a fresh
    closure, so ``jax.jit``'s function-identity cache never hit and each
    call paid a full retrace+compile (~1 s for a dim-16 solve) — the cache
    makes repeat eager solves with the same ``rhs`` object run at compiled
    speed."""
    from ..utils.jit_tools import cjit

    kwargs = dict(
        method=method, rtol=rtol, atol=atol, max_steps=max_steps,
        first_step=first_step, auto_jit=False, stepper=stepper,
    )
    if with_t_eval:
        return cjit(lambda ts, y, te: tpu_rk_solve(rhs, ts, y, t_eval=te, **kwargs))
    return cjit(lambda ts, y: tpu_rk_solve(rhs, ts, y, **kwargs))


def tpu_rk_solve(
    rhs: Callable,
    t_span,
    y0,
    t_eval=None,
    method: str = "dopri5",
    rtol: float = 1e-8,
    atol: float = 1e-10,
    max_steps: int = 16384,
    first_step: Optional[float] = None,
    auto_jit: bool = True,
    stepper: str = "auto",
):
    """Adaptive embedded-RK solve of ``dy/dt = rhs(t, y)`` under ``jit``.

    Returns an :class:`OdeResult` with solutions at the merged
    ``t_span``/``t_eval`` time points (exact stopping, no interpolation).

    When called outside a JAX trace, the solve self-jits (with a ``cjit``
    boundary) — dramatically faster than eager execution. Each call
    compiles for its ``rhs`` closure; for parameter sweeps, wrap the whole
    computation in ``jit``/``vmap`` instead (the internal jit then inlines).

    ``stepper`` selects the time-loop construct:

    - ``"while"``: ``lax.while_loop`` with early exit — runtime proportional
      to steps actually taken (a 100-step solve does 100 iterations, not
      ``max_steps``). Not reverse-mode differentiable (XLA while has no
      transpose); ``vmap`` is supported (per-lane ``active`` masking).
    - ``"scan"``: bounded ``lax.scan`` over ``max_steps`` masked iterations —
      reverse-mode differentiable, but always pays the full budget
      (the reference analog, ``jax.experimental.ode.odeint``, uses a while
      loop with a custom adjoint instead; here the fused sweep kernels own
      the fast differentiable path).
    - ``"auto"`` (default): ``"while"`` on eager (self-jitting) calls, where
      this function controls the trace and no gradient can cross it;
      ``"scan"`` inside any user trace, where a ``grad`` may be in flight.
    """
    if stepper not in ("auto", "while", "scan"):
        raise ValueError(f"stepper must be 'auto', 'while' or 'scan', got {stepper!r}")
    # skip self-jit inside any trace; `_in_trace` misses vmap (constants are
    # not BatchTracers), so also check the arguments themselves
    args_traced = any(
        isinstance(x, jax.core.Tracer)
        for x in jax.tree_util.tree_leaves((t_span, y0, t_eval))
    )
    in_user_trace = _in_trace() or args_traced
    if stepper == "auto":
        stepper = "scan" if in_user_trace else "while"
    if auto_jit and not in_user_trace:
        try:
            fn = _compiled_rk(
                rhs, method, rtol, atol, max_steps, first_step, stepper,
                t_eval is not None,
            )
        except TypeError:  # unhashable rhs (rare): uncached compile
            fn = _compiled_rk.__wrapped__(
                rhs, method, rtol, atol, max_steps, first_step, stepper,
                t_eval is not None,
            )
        if t_eval is None:
            return fn(np.asarray(t_span, dtype=float), y0)
        return fn(np.asarray(t_span, dtype=float), y0, np.asarray(t_eval, dtype=float))
    tableau = _DOPRI5 if method == "dopri5" else _DOP853
    error_norm_fn = _dopri5_error_norm if method == "dopri5" else _dop853_error_norm
    A, B, C = tableau.A, tableau.B, tableau.C
    n_stages = tableau.n_stages
    err_exp = tableau.err_exp

    y0 = jnp.asarray(y0)
    if not jnp.iscomplexobj(y0):
        y0 = y0.astype(jnp.result_type(y0.dtype, jnp.float32))

    t_list = merge_t_args_jax(t_span, t_eval)
    t_list = jnp.asarray(t_list, dtype=jnp.result_type(float))
    n_targets = t_list.shape[0]

    # time reflection so the internal clock always increases
    sigma = jnp.where(t_list[-1] >= t_list[0], 1.0, -1.0)
    s_list = sigma * t_list

    def f(s, y):
        return sigma * rhs(sigma * s, y)

    s0 = s_list[0]
    f0 = f(s0, y0)
    if first_step is None:
        h0 = _select_initial_step(f, s0, y0, f0, err_exp, rtol, atol)
    else:
        h0 = jnp.asarray(first_step, dtype=s_list.dtype)

    ys_out = jnp.zeros((n_targets - 1,) + y0.shape, dtype=y0.dtype)

    def rk_step(state):
        s, y, fc, h, target_idx, ys_acc, nfev = state
        active = target_idx < n_targets

        s_target = s_list[jnp.minimum(target_idx, n_targets - 1)]
        gap = s_target - s
        clipped = h >= gap
        h_eff = jnp.where(clipped, gap, h)

        # --- RK stages (unrolled; FSAL first stage) ---
        K = [fc]
        for i in range(1, n_stages):
            incr = sum(A[i, j] * K[j] for j in range(i))
            K.append(f(s + C[i] * h_eff, y + h_eff * incr))
        y_new = y + h_eff * sum(B[i] * K[i] for i in range(n_stages))
        f_new = f(s + h_eff, y_new)
        K.append(f_new)
        K = jnp.stack(K)
        nfev = nfev + jnp.where(active, n_stages, 0)

        # step control is non-differentiable by construction: gradients flow
        # through the accepted states, never through step-size selection
        scale = atol + rtol * jnp.maximum(_cabs(y), _cabs(y_new))
        err_norm = lax.stop_gradient(error_norm_fn(K, h_eff, scale))

        accept = (err_norm <= 1.0) | (h_eff <= 1e-14 * jnp.maximum(1.0, jnp.abs(s)))

        # step-size update (scipy factors); double-where guards the 0**neg branch
        err_safe = jnp.where(err_norm == 0.0, 1.0, err_norm)
        raw_factor = _SAFETY * jnp.where(err_norm == 0.0, _MAX_FACTOR,
                                         err_safe ** err_exp)
        factor = jnp.clip(raw_factor, _MIN_FACTOR, _MAX_FACTOR)
        factor = jnp.where(accept, factor, jnp.clip(factor, _MIN_FACTOR, 1.0))
        h_next = jnp.where(clipped & accept, h, h_eff * factor)
        h_next = jnp.where(accept & ~clipped, h_eff * factor, h_next)
        h_next = jnp.where(~accept, h_eff * factor, h_next)

        do = active & accept
        s_new = jnp.where(do, s + h_eff, s)
        y_next = jnp.where(do, y_new, y)
        fc_next = jnp.where(do, f_new, fc)

        reached = do & clipped
        out_idx = jnp.clip(target_idx - 1, 0, n_targets - 2)
        updated = ys_acc.at[out_idx].set(y_new)
        ys_acc = jnp.where(reached, updated, ys_acc)
        target_idx = target_idx + jnp.where(reached, 1, 0)

        h_new = jnp.where(active, h_next, h)
        return (s_new, y_next, fc_next, h_new, target_idx, ys_acc, nfev)

    init = (s0, y0, f0, h0, jnp.asarray(1), ys_out, jnp.asarray(2))
    if stepper == "while":
        # early exit: runtime ~ steps taken. The step counter rides outside
        # the shared state; per-lane `active` masking inside rk_step keeps
        # finished lanes frozen under vmap (vmapped while runs until ALL
        # lanes finish).
        def w_cond(carry):
            state, n_steps = carry
            return jnp.any(state[4] < n_targets) & (n_steps < max_steps)

        def w_body(carry):
            state, n_steps = carry
            return rk_step(state), n_steps + 1

        (s_f, y_f, _, _, target_idx_f, ys_acc, nfev), _ = lax.while_loop(
            w_cond, w_body, (init, jnp.asarray(0))
        )
    else:
        (s_f, y_f, _, _, target_idx_f, ys_acc, nfev), _ = lax.scan(
            lambda state, _: (rk_step(state), None), init, None, length=max_steps
        )

    # NaN-poison if the step budget was exhausted before reaching t_span[1]
    completed = target_idx_f >= n_targets
    # poison value must not be a function of ys_acc: `nan * ys_acc` would leak
    # NaN into the transpose (backward of x -> nan*x) even when unselected
    ys_acc = jnp.where(completed, ys_acc, jnp.full_like(ys_acc, jnp.nan))

    ys = jnp.concatenate([y0[None], ys_acc], axis=0)
    results = OdeResult(t=t_list, y=ys, nfev=nfev, success=completed)
    return trim_t_results_jax(results, t_eval)


def tpu_dopri5(rhs, t_span, y0, t_eval=None, **kwargs):
    """Adaptive Dormand-Prince 5(4) under jit (native)."""
    return tpu_rk_solve(rhs, t_span, y0, t_eval=t_eval, method="dopri5", **kwargs)


def tpu_dop853(rhs, t_span, y0, t_eval=None, **kwargs):
    """Adaptive DOP853 (8th order) under jit (native)."""
    return tpu_rk_solve(rhs, t_span, y0, t_eval=t_eval, method="dop853", **kwargs)
