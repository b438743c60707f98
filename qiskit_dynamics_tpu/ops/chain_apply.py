r"""Propagator-chain application: ``y_b <- U_{T-1,b} ... U_{0,b} y_b``.

The sequential half of Dysolve-style steppers (the reference composes with
``associative_scan``, ``perturbative_solver.py:189-210``, which materializes
log-depth intermediate products; for a final-state-only solve the streamed
chain does strictly less work). One ``lax.scan`` of batched mat-vecs: memory
bound, with nothing for a hand-written kernel to fuse.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["chain_apply"]


def chain_apply(props, y0):
    """Apply a per-member propagator chain to a state.

    Differentiable in ``props`` and ``y0``: the scan step is checkpointed,
    so reverse-mode AD stores only the per-step state.

    Args:
        props: (T, B, n, n) complex per-step propagators (step 0 first).
        y0: (B, n) complex initial states.

    Returns:
        (B, n) complex final states.
    """
    if props.shape[0] == 0:
        raise ValueError("chain_apply requires at least one propagator (T >= 1).")

    def step(y, u):
        return jnp.einsum("bij,bj->bi", u, y), None

    yf, _ = jax.lax.scan(jax.checkpoint(step), jnp.asarray(y0), jnp.asarray(props))
    return yf
