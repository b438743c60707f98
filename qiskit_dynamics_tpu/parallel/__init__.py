"""Multi-device parallelism: device meshes, sharded sweeps, sharded scans.

New infrastructure with no counterpart in the reference (which is
single-process; SURVEY.md §2.13/§5).
"""
from .mesh import DATA_AXIS, TIME_AXIS, make_mesh, data_mesh, batch_sharding, local_device_count
from .sweep import pvmap, sharded_sweep, pshard_batch
from .scan import propagator_scan, sharded_propagator_scan
from .tensor import (
    MODEL_AXIS,
    model_mesh,
    shard_rows,
    tensor_expm_chain,
    tensor_magnus_solve,
)

__all__ = [
    "DATA_AXIS",
    "TIME_AXIS",
    "MODEL_AXIS",
    "model_mesh",
    "shard_rows",
    "tensor_expm_chain",
    "tensor_magnus_solve",
    "make_mesh",
    "data_mesh",
    "batch_sharding",
    "local_device_count",
    "pvmap",
    "pshard_batch",
    "sharded_sweep",
    "propagator_scan",
    "sharded_propagator_scan",
]
