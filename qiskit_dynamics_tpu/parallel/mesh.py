"""Device-mesh management for multi-device execution.

The reference has no distributed runtime at all (SURVEY.md §2.13/§5; verified:
no ``pmap``/``shard_map``/``pjit``/collectives anywhere in
upstream ``qiskit_dynamics``). This module builds ``jax.sharding.Mesh``
objects over the local devices and provides the axis conventions used by the
sharded solve drivers. The four cards of one host are joined all to all by
NVLink, so the mesh shape follows the algorithm alone:

- ``"data"`` — the simulation-batch axis (parameter sweeps, schedule batches,
  batched initial states). Embarrassingly parallel; no collectives inside a
  solve, only at result-gather time.
- ``"time"`` — the time-step axis of parallel propagator composition
  (:mod:`.scan`): one all-gather of the per-shard block totals.
- ``"model"`` — Hilbert-space row sharding of the matrices themselves
  (:mod:`.tensor`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["DATA_AXIS", "TIME_AXIS", "make_mesh", "data_mesh", "local_device_count"]

DATA_AXIS = "data"
TIME_AXIS = "time"


def local_device_count() -> int:
    return len(jax.devices())


def make_mesh(
    axis_shapes: Optional[Union[int, Sequence[int]]] = None,
    axis_names: Tuple[str, ...] = (DATA_AXIS,),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ``Mesh`` over the available devices.

    Args:
        axis_shapes: mesh shape; defaults to all devices on one axis. An int is
            treated as a 1-axis shape.
        axis_names: logical axis names, default ``("data",)``.
        devices: explicit device list; defaults to ``jax.devices()``.

    Returns:
        ``jax.sharding.Mesh``.
    """
    if devices is None:
        devices = jax.devices()
    if axis_shapes is None:
        axis_shapes = (len(devices),) + (1,) * (len(axis_names) - 1)
    elif isinstance(axis_shapes, int):
        axis_shapes = (axis_shapes,)
    axis_shapes = tuple(int(s) for s in axis_shapes)
    if len(axis_shapes) != len(axis_names):
        raise ValueError("axis_shapes and axis_names must have equal length.")
    n = int(np.prod(axis_shapes))
    if n > len(devices):
        raise ValueError(
            f"Mesh of shape {axis_shapes} needs {n} devices; only {len(devices)} available."
        )
    dev_array = np.asarray(devices[:n]).reshape(axis_shapes)
    return Mesh(dev_array, axis_names)


def data_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-axis ``("data",)`` mesh over ``n_devices`` (default: all)."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    return make_mesh((n_devices,), (DATA_AXIS,), devices=devices)


def batch_sharding(mesh: Mesh, axis_name: str = DATA_AXIS, ndim: int = 1) -> NamedSharding:
    """Sharding placing dim 0 on ``axis_name``, replicating the rest."""
    spec = PartitionSpec(axis_name, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)
