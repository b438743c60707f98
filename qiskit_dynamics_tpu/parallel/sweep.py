"""Sharded parameter-sweep driver (the "data parallel" axis).

The reference executes batch simulations **serially in a Python loop**
(``/root/reference/qiskit_dynamics/solvers/solver_classes.py:569-586``). Here a
sweep is one SPMD program: the parameter batch is sharded over the mesh's
``"data"`` axis with ``shard_map``, each chip ``vmap``s its shard, and XLA
gathers results. Non-divisible batches are zero-padded (results trimmed), so
one compiled executable serves every sweep size with the same per-chip shape.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .mesh import DATA_AXIS, data_mesh
from ..utils.jit_tools import cjit

__all__ = ["pvmap", "sharded_sweep"]


def _pad_to(x, n: int):
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return jnp.concatenate([x, jnp.broadcast_to(x[:1], (pad,) + x.shape[1:])], axis=0)


def pvmap(
    fn: Callable,
    mesh: Optional[Mesh] = None,
    axis_name: str = DATA_AXIS,
) -> Callable:
    """``vmap`` sharded over a device mesh.

    ``pvmap(f)(batch)`` maps ``f`` over dim 0 of every leaf of ``batch``,
    splitting the batch across the mesh's ``axis_name`` axis and vmapping each
    per-chip shard. The batch is padded (by repeating the first element) up to
    a multiple of the axis size and the padding is trimmed from the result, so
    any batch size works and compiles once per padded shard shape.

    Args:
        fn: function of one pytree argument (single example, no batch dim).
        mesh: device mesh; default ``data_mesh()`` over all devices.
        axis_name: mesh axis to shard the batch over.

    Returns:
        Function mapping a batched pytree -> batched results.
    """

    @functools.wraps(fn)
    def mapped(batch):
        m = mesh if mesh is not None else data_mesh()
        n_shards = m.shape[axis_name]
        leaves = jax.tree_util.tree_leaves(batch)
        if not leaves:
            raise ValueError("pvmap requires at least one array leaf in the batch.")
        batch_size = leaves[0].shape[0]
        padded = -(-batch_size // n_shards) * n_shards

        batch_p = jax.tree_util.tree_map(lambda x: _pad_to(jnp.asarray(x), padded), batch)

        in_spec = jax.tree_util.tree_map(
            lambda x: P(axis_name, *([None] * (x.ndim - 1))), batch_p
        )

        local_fn = jax.vmap(fn)
        eval_shape = jax.eval_shape(local_fn, batch_p)
        out_spec = jax.tree_util.tree_map(
            lambda s: P(axis_name, *([None] * (len(s.shape) - 1))), eval_shape
        )

        sharded = shard_map(
            local_fn, mesh=m, in_specs=(in_spec,), out_specs=out_spec, check_vma=False
        )
        out = sharded(batch_p)
        return jax.tree_util.tree_map(lambda x: x[:batch_size], out)

    return mapped


def pshard_batch(
    fn_batch: Callable,
    mesh: Optional[Mesh] = None,
    axis_name: str = DATA_AXIS,
) -> Callable:
    """Shard a *batch-level* function over the mesh.

    Unlike :func:`pvmap` (which maps a single-example function), ``fn_batch``
    already consumes a whole batch (dim 0) — e.g. a fused Pallas sweep kernel
    — and is applied independently to each chip's shard. The batch is padded
    to a multiple of the axis size and trimmed on return.
    """

    @functools.wraps(fn_batch)
    def mapped(batch):
        m = mesh if mesh is not None else data_mesh()
        n_shards = m.shape[axis_name]
        leaves = jax.tree_util.tree_leaves(batch)
        batch_size = leaves[0].shape[0]
        padded = -(-batch_size // n_shards) * n_shards
        batch_p = jax.tree_util.tree_map(lambda x: _pad_to(jnp.asarray(x), padded), batch)

        in_spec = jax.tree_util.tree_map(
            lambda x: P(axis_name, *([None] * (x.ndim - 1))), batch_p
        )
        eval_shape = jax.eval_shape(
            fn_batch, jax.tree_util.tree_map(lambda x: x[: padded // n_shards], batch_p)
        )
        out_spec = jax.tree_util.tree_map(
            lambda s: P(axis_name, *([None] * (len(s.shape) - 1))), eval_shape
        )
        sharded = shard_map(
            fn_batch, mesh=m, in_specs=(in_spec,), out_specs=out_spec, check_vma=False
        )
        out = sharded(batch_p)
        return jax.tree_util.tree_map(lambda x: x[:batch_size], out)

    return mapped


def sharded_sweep(
    fn: Callable,
    params,
    mesh: Optional[Mesh] = None,
    axis_name: str = DATA_AXIS,
    jit: bool = True,
):
    """Run ``fn`` over a parameter batch, sharded across the mesh.

    One-shot convenience over :func:`pvmap`: jits the mapped function with
    ``cjit`` (complex values cross the boundary as real/imag pairs) and
    applies it to ``params``.
    """
    mapped = pvmap(fn, mesh=mesh, axis_name=axis_name)
    if jit:
        mapped = cjit(mapped)
    return mapped(params)
