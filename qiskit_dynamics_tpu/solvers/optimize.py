r"""Gradient-based pulse/control optimization (GRAPE-style).

Capability beyond the reference: qiskit-dynamics documents "optimize through
your simulation with JAX" as a workflow (ref ``README.md:18-21``, userguide
JAX how-to) but ships no optimization API — every user writes the same
optax loop by hand. This module packages that loop as one device program:

- :func:`optimize_controls`: a compiled fixed-step optimizer drive
  (``lax.scan`` over optimizer steps — ONE executable for the whole
  optimization, no per-step dispatch) with **batched multi-start**: the
  restart axis rides the same differentiable batch machinery as parameter
  sweeps (``vmap`` over the loss; elementwise optax transforms then update
  every restart independently inside one device program). A 512-restart
  GRAPE run costs one fused sweep per step, not 512 loops.
- :func:`state_infidelity` / :func:`unitary_infidelity`: the standard
  phase-invariant objectives, batch-aware.

The loss function is arbitrary jax-differentiable code — typically a
:class:`~qiskit_dynamics_tpu.Solver` solve (``method="tpu_dopri5"``), a
:func:`~qiskit_dynamics_tpu.solvers.fused_sweep_solve` call (batched
reverse-mode AD through one scan: the fastest gradient path), or a perturbative
solver step.

Notes:
    Multi-start correctness relies on the optimizer transform being
    elementwise per parameter entry (``optax.adam``/``sgd``/``rmsprop``…);
    transforms that couple entries through shared scalar state (e.g.
    global-norm clipping, L-BFGS) would couple restarts — pass those only
    with a single start.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..exceptions import DynamicsError
from ..utils.jit_tools import cjit
from .adaptive import _cabs

try:  # pragma: no cover - optax is present in the target environment
    import optax
except ImportError:  # pragma: no cover
    optax = None

__all__ = ["OptimizeResult", "optimize_controls", "state_infidelity", "unitary_infidelity"]


def state_infidelity(y, target, normalize: bool = True):
    r""":math:`1 - |\langle \mathrm{target}|y\rangle|^2`, batch-aware.

    Args:
        y: state(s), shape ``(..., n)``.
        target: target state(s), shape broadcastable to ``y``.
        normalize: divide by both norms (default) so unnormalized solver
            output (e.g. f32 roundoff drift) does not bias the objective.

    Returns:
        Real infidelity with the broadcast batch shape of ``(..., )``.
    """
    y = jnp.asarray(y)
    target = jnp.asarray(target)
    overlap = jnp.abs(jnp.sum(jnp.conj(target) * y, axis=-1)) ** 2
    if normalize:
        # _cabs, not jnp.abs: `target` is typically a closed-over constant
        # like [0, 1], and abs of a complex iota-shaped constant crashes
        # XLA:CPU's algebraic simplifier (see adaptive._cabs).
        overlap = overlap / (
            jnp.sum(_cabs(target) ** 2, axis=-1) * jnp.sum(_cabs(y) ** 2, axis=-1)
        )
    return 1.0 - overlap


def unitary_infidelity(U, target, subspace_dim: Optional[int] = None):
    r"""Phase-invariant gate infidelity :math:`1 - |\mathrm{Tr}(T^\dagger U)|^2/d^2`.

    Args:
        U: propagator(s), shape ``(..., n, n)``.
        target: target unitary, shape ``(..., n, n)`` (or ``(d, d)`` acting on
            the leading ``d``-dimensional computational subspace of ``U`` when
            ``subspace_dim=d < n`` — the transmon-with-leakage case: only the
            qubit block enters the trace, leakage shows up as lost norm).
        subspace_dim: optional computational-subspace dimension ``d``.

    Returns:
        Real infidelity with shape ``U.shape[:-2]``.
    """
    U = jnp.asarray(U)
    target = jnp.asarray(target)
    if subspace_dim is not None:
        d = int(subspace_dim)
        U = U[..., :d, :d]
        target = target[..., :d, :d]
    d = U.shape[-1]
    tr = jnp.sum(jnp.conj(target) * U, axis=(-2, -1))  # Tr(T^dagger U)
    return 1.0 - jnp.abs(tr) ** 2 / d**2


class OptimizeResult(NamedTuple):
    """Result of :func:`optimize_controls`.

    Attributes:
        params: best-seen parameters — the iterate with the lowest loss over
            the whole run, not the final iterate. With ``multi_start`` the
            leaves keep their leading restart axis (per-restart best).
        loss: best-seen loss — scalar, or ``(restarts,)`` with ``multi_start``.
        best_index: argmin restart index (``None`` for a single start).
        loss_history: per-step evaluated loss, ``(steps,)`` or
            ``(steps, restarts)``.
        params_final: the final iterate(s) (for warm-starting a follow-up run).
    """

    params: Any
    loss: Any
    best_index: Optional[int]
    loss_history: Any
    params_final: Any

    @property
    def best_params(self):
        """Best parameters overall (restart axis selected out)."""
        if self.best_index is None:
            return self.params
        i = self.best_index
        return jax.tree_util.tree_map(lambda x: x[i], self.params)

    @property
    def best_loss(self):
        """Best loss overall (scalar)."""
        if self.best_index is None:
            return self.loss
        return self.loss[self.best_index]


def optimize_controls(
    loss_fn: Callable,
    params0,
    *,
    optimizer=None,
    steps: int = 200,
    multi_start: bool = False,
    loss_aux: bool = False,
):
    r"""Minimize a differentiable control objective, entirely on device.

    The whole optimization — ``steps`` iterations of value-and-grad plus the
    optax update — compiles to one ``lax.scan`` executable (complex-safe
    I/O boundaries via :func:`~qiskit_dynamics_tpu.utils.cjit`). The best
    iterate is tracked in-scan, so a late-run overshoot cannot lose the
    optimum.

    Args:
        loss_fn: ``params -> scalar`` jax-differentiable objective (or
            ``params -> (scalar, aux)`` with ``loss_aux=True``; aux is
            discarded from the scan carry but keeps the signature usable).
        params0: initial parameter pytree. With ``multi_start=True`` every
            leaf carries a leading restart axis of common length ``R`` and
            ``loss_fn`` is evaluated per restart (``vmap``).
        optimizer: an ``optax.GradientTransformation``; default
            ``optax.adam(0.1)``. Must be elementwise for ``multi_start``
            (see module notes).
        steps: fixed iteration count (static — part of the compiled scan).
        multi_start: treat the leading axis of every leaf as independent
            restarts optimized simultaneously.
        loss_aux: ``loss_fn`` returns ``(loss, aux)``.

    Returns:
        :class:`OptimizeResult`.

    Raises:
        DynamicsError: if optax is unavailable or restart axes disagree.
    """
    if optax is None:  # pragma: no cover
        raise DynamicsError("optimize_controls requires optax.")
    if steps < 1:
        raise DynamicsError("optimize_controls: steps must be >= 1.")
    opt = optimizer if optimizer is not None else optax.adam(0.1)

    params0 = jax.tree_util.tree_map(jnp.asarray, params0)
    leaves = jax.tree_util.tree_leaves(params0)
    if not leaves:
        raise DynamicsError("optimize_controls: params0 has no array leaves.")

    if multi_start:
        sizes = {leaf.shape[0] if leaf.ndim else None for leaf in leaves}
        if None in sizes or len(sizes) != 1:
            raise DynamicsError(
                "multi_start=True requires every params0 leaf to carry the "
                f"same leading restart axis; got leading sizes {sizes}."
            )
        stacked = params0
    else:
        stacked = jax.tree_util.tree_map(lambda x: x[None], params0)

    base_loss = loss_fn
    if loss_aux:
        base_loss = lambda p: loss_fn(p)[0]
    per_restart = jax.vmap(base_loss)

    def total_loss(p):
        per = per_restart(p)
        return jnp.sum(per), per

    vg = jax.value_and_grad(total_loss, has_aux=True)

    def run(p0):
        ostate = opt.init(p0)
        big = jnp.full(jax.tree_util.tree_leaves(p0)[0].shape[:1], jnp.inf)

        def merge_best(best_p, best_l, p, per):
            improved = per < best_l
            best_p = jax.tree_util.tree_map(
                lambda bp, cur: jnp.where(
                    improved.reshape(improved.shape + (1,) * (cur.ndim - 1)), cur, bp
                ),
                best_p,
                p,
            )
            return best_p, jnp.minimum(best_l, per)

        def step(carry, _):
            p, s, best_p, best_l = carry
            (_, per), grads = vg(p)
            # steepest descent for a real loss of complex parameters is along
            # -conj(grad) (Wirtinger calculus); jax.grad returns the
            # unconjugated cotangent, which ASCENDS in the imaginary parts
            grads = jax.tree_util.tree_map(
                lambda g: g.conj() if jnp.iscomplexobj(g) else g, grads
            )
            updates, s = opt.update(grads, s, p)
            p_new = optax.apply_updates(p, updates)
            best_p, best_l = merge_best(best_p, best_l, p, per)
            return (p_new, s, best_p, best_l), per

        (p_fin, _, best_p, best_l), hist = jax.lax.scan(
            step, (p0, ostate, p0, big), None, length=steps
        )
        # the final iterate was produced but never evaluated in-scan; score
        # it so a run that converges on its last update is not under-reported
        best_p, best_l = merge_best(best_p, best_l, p_fin, per_restart(p_fin))
        return best_p, best_l, hist, p_fin

    best_p, best_l, hist, p_fin = cjit(run)(stacked)

    if multi_start:
        best_index = int(np.argmin(np.asarray(best_l)))
        return OptimizeResult(best_p, best_l, best_index, hist, p_fin)
    unstack = lambda tree: jax.tree_util.tree_map(lambda x: x[0], tree)
    return OptimizeResult(
        unstack(best_p), best_l[0], None, hist[:, 0], unstack(p_fin)
    )
