"""Multi-device propagator composition: sharded associative scan over time.

The reference's only "scan parallelism" is a single-device
``jax.lax.associative_scan`` over per-step propagators
(``/root/reference/qiskit_dynamics/solvers/fixed_step_solvers.py:589-608``).
JAX does not provide a multi-device associative scan out of the box, so this
module implements the classic blockwise prefix algorithm over a device mesh:

1. the (T, n, n) stack of per-step propagators is sharded on the time axis;
2. each device runs a local log-depth ``associative_scan`` on its block;
3. each device's *block total* (last cumulative propagator) is
   ``all_gather``-ed — O(P) matrices of size (n, n), one collective;
4. each device composes the exclusive prefix of earlier block totals into
   its local cumulative products with one batched matmul.

Propagator composition order matches the reference's ``reverse_mul``: the
cumulative product at step k is ``U_k = P_k @ P_{k-1} @ ... @ P_1``.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.lax import associative_scan
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .mesh import TIME_AXIS, make_mesh

__all__ = ["sharded_propagator_scan", "propagator_scan"]


def _rev_matmul(a, b):
    return jnp.matmul(b, a)


def propagator_scan(step_propagators):
    """Single-device cumulative propagator products (log-depth)."""
    return associative_scan(_rev_matmul, step_propagators, axis=0)


def sharded_propagator_scan(
    step_propagators,
    mesh: Optional[Mesh] = None,
    axis_name: str = TIME_AXIS,
):
    """Cumulative products of a (T, n, n) propagator stack, sharded over time.

    ``out[k] = step_propagators[k] @ ... @ step_propagators[0]``.

    ``T`` must be divisible by the mesh axis size (pad with identities
    upstream if needed; identity padding leaves trailing products unchanged).

    Args:
        step_propagators: (T, n, n) complex array of per-step propagators.
        mesh: mesh containing ``axis_name``; default a 1-axis ``("time",)``
            mesh over all devices.
        axis_name: mesh axis carrying the time shards.

    Returns:
        (T, n, n) cumulative products, same sharding as the input.
    """
    if mesh is None:
        mesh = make_mesh(axis_names=(axis_name,))
    n_shards = mesh.shape[axis_name]
    T = step_propagators.shape[0]
    if T % n_shards != 0:
        raise ValueError(
            f"Time length {T} not divisible by mesh axis '{axis_name}' size {n_shards}; "
            "pad with identity propagators."
        )

    def block_fn(props):
        # props: (T/P, n, n) local block
        local = associative_scan(_rev_matmul, props, axis=0)
        totals = jax.lax.all_gather(local[-1], axis_name)  # (P, n, n)
        idx = jax.lax.axis_index(axis_name)

        # exclusive prefix of earlier block totals, composed oldest-first:
        # prefix = totals[idx-1] @ ... @ totals[0]
        eye = jnp.eye(props.shape[-1], dtype=props.dtype)

        def body(j, acc):
            return jnp.where(j < idx, totals[j] @ acc, acc)

        prefix = jax.lax.fori_loop(0, n_shards, body, eye)
        return jnp.matmul(local, prefix)

    spec = P(axis_name, None, None)
    fn = shard_map(block_fn, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    return fn(step_propagators)
