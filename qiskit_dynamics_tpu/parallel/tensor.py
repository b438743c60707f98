r"""Tensor (Hilbert-space) sharding: large-dim solves across devices.

Third parallel axis, complementing ``"data"`` (:mod:`.sweep`) and ``"time"``
(:mod:`.scan`): shard the *matrices themselves* — operators, propagators,
states — over a ``"model"`` mesh axis, so a single solve whose
:math:`O(n^3)` matmul cost exceeds one device runs SPMD over the device
interconnect (NVLink between the cards of one host). The reference is
single-process with no counterpart (SURVEY.md §5); this module is new
capability.

The design follows the scaling-book recipe verbatim: pick a mesh, annotate
shardings (row-sharded ``P("model", None)`` matrices here), and let XLA's
GSPMD partitioner insert the collectives. Per complex matmul each device
computes an ``(n/P, n) @ (n, n)`` local product (``n^3/P`` FLOPs) and the
chain's next step all-gathers the ``n^2/P`` row shard — comms
:math:`O(n^2)` against compute :math:`O(n^3/P)`, so the axis pays off once
``n`` is large (the crossover on NVLink-joined cards is not measured yet;
below it use ``"data"``/``"time"`` sharding, which never communicate
mid-solve). Axes
compose: a ``("data", "model")`` mesh runs a BATCH of chains with the batch
on ``"data"`` and every matrix row-sharded on ``"model"``.

Correctness is mesh-size-independent (GSPMD partitions a fixed program), so
the 8-device virtual CPU mesh validates what real multi-device hardware would
run; ``__graft_entry__.dryrun_multichip`` exercises this module end-to-end.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS, make_mesh

__all__ = [
    "MODEL_AXIS",
    "model_mesh",
    "shard_rows",
    "tensor_expm_chain",
    "tensor_magnus_solve",
]

MODEL_AXIS = "model"


def model_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-axis ``"model"`` mesh over ``n_devices`` (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return make_mesh(len(devices), (MODEL_AXIS,), devices=devices)


def shard_rows(x, mesh: Mesh, batch_axes: int = 0):
    """Device-put ``x`` with its row dim (axis ``batch_axes``) sharded.

    ``batch_axes`` leading dims are sharded over ``"data"`` when the mesh has
    that axis, else replicated; the first matrix dim shards over ``"model"``.
    """
    data = DATA_AXIS if DATA_AXIS in mesh.shape and batch_axes else None
    spec = P(*((data,) * min(1, batch_axes) + (None,) * (batch_axes - 1)
               + (MODEL_AXIS,) + (None,) * (jnp.ndim(x) - batch_axes - 1)))
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def tensor_expm_chain(
    generators, dt: float, y0, mesh: Mesh,
    order: int = 12, squarings: int = 2,
):
    """Propagator chain ``y <- expm(G_t dt) @ y`` with row-sharded matrices.

    Same step semantics/polynomial as :func:`..benchmarks.expm_chain`, but
    every ``(n, n)`` matrix is sharded ``P("model", None)`` over the mesh so
    the :math:`O(n^3)` expm/apply matmuls split across devices (GSPMD inserts
    the all-gathers). Accepts batched ``(T, b, n, n)`` generators with
    ``(b, n, n|m)`` states — the batch dim additionally shards over a
    ``"data"`` axis when the mesh has one (2-d tensor+data parallelism).

    Args:
        generators: ``(T, n, n)`` or ``(T, b, n, n)`` complex generators.
        dt: step size.
        y0: ``(n, m)`` / ``(b, n, m)`` initial states or propagators.
        mesh: mesh with a ``"model"`` axis (optionally also ``"data"``).
        order / squarings: as in :func:`..ops.expm.expm_taylor`.

    Returns:
        Final states, sharded like ``y0`` (same leading-batch convention).
    """
    from ..ops.expm import expm_taylor

    if MODEL_AXIS not in mesh.shape:
        raise ValueError(f'mesh must have a "{MODEL_AXIS}" axis; got {mesh.shape}.')
    generators = jnp.asarray(generators)
    y0 = jnp.asarray(y0)
    batched = generators.ndim == 4
    data = DATA_AXIS if (batched and DATA_AXIS in mesh.shape) else None
    b_axes = (data,) if batched else ()
    g_spec = P(None, *b_axes, MODEL_AXIS, None)   # time leading, rows sharded
    y_spec = P(*b_axes, MODEL_AXIS, None)
    gen = jax.device_put(generators, NamedSharding(mesh, g_spec))
    y = jax.device_put(y0, NamedSharding(mesh, y_spec))

    @jax.jit
    def run(gen, y):
        constraint = NamedSharding(mesh, y_spec)

        def step(y, g):
            prop = expm_taylor(g * dt, order=order, squarings=squarings)
            y = jax.lax.with_sharding_constraint(prop @ y, constraint)
            return y, None

        yf, _ = jax.lax.scan(step, y, gen)
        return yf

    return run(gen, y)


def tensor_magnus_solve(
    model, t_span, y0, mesh: Mesh, max_dt: float, t_eval=None,
    magnus_order: int = 2, expm_order: int = 12, expm_squarings: int = 2,
):
    """Model-level fixed-step Magnus solve with Hilbert-space-sharded matmuls.

    The large-dim counterpart of ``solve_lmde(method="jax_expm",
    expm_method="taylor")`` — also reachable as ``solve_lmde(method=
    "tensor_expm", mesh=...)``. Identical step rule, time grid, and frame
    handling (the shared fixed-step template over
    :func:`..solvers.fixed_step_solvers.get_exponential_take_step`), but
    every per-step generator, Magnus matrix, and expm intermediate carries a
    ``P("model", None)`` sharding constraint, so GSPMD splits the
    :math:`O(n^3)` expm matmuls across the mesh. The model's stored
    operators stay replicated (memory :math:`O(n^2)` per device — not the
    constraint until ``n ~ 30k``); the FLOPs shard. Differentiable like the
    single-device path (plain ``jnp`` + scan under the constraints).

    Args:
        model: a ``GeneratorModel``/``HamiltonianModel`` (or vectorized
            ``LindbladModel``) with concrete signals set.
        t_span: ``(t0, tf)``.
        y0: initial state ``(n,)`` or matrix ``(n, m)``.
        mesh: mesh with a ``"model"`` axis.
        max_dt: step bound (intervals between requested times subdivide into
            equal steps ``<= max_dt``, as in the fixed-step solvers).
        t_eval: optional evaluation times within ``t_span``.
        magnus_order: 1-3, as in the fixed-step solvers.
        expm_order / expm_squarings: Taylor expm parameters (``ops/expm.py``).

    Returns:
        ``OdeResult`` with the ``solve_lmde`` conventions (standard basis,
        in-frame values); ``result.y`` stays sharded over ``"model"``.
    """
    from ..ops.expm import expm_taylor
    from ..solvers.fixed_step_solvers import (
        fixed_step_solver_template_jax,
        get_exponential_take_step,
    )
    from ..solvers.results import OdeResult
    from ..solvers.solver_functions import (
        results_y_out_of_frame_basis,
        setup_generator_model_rhs_y0_in_frame_basis,
    )
    from ..solvers.solver_utils import merge_t_args

    if MODEL_AXIS not in mesh.shape:
        raise ValueError(f'mesh must have a "{MODEL_AXIS}" axis; got {mesh.shape}.')

    generator, _, y0_fb, prev_flag = setup_generator_model_rhs_y0_in_frame_basis(
        model, jnp.asarray(y0, dtype=complex)
    )
    try:
        mat_sharding = NamedSharding(mesh, P(MODEL_AXIS, None))
        y_spec = P(MODEL_AXIS, *((None,) * (jnp.ndim(y0_fb) - 1)))
        y_sharding = NamedSharding(mesh, y_spec)

        def sharded_generator(t):
            return jax.lax.with_sharding_constraint(generator(t), mat_sharding)

        def expm_func(a):
            a = jax.lax.with_sharding_constraint(a, mat_sharding)
            p = expm_taylor(a, order=expm_order, squarings=expm_squarings)
            return jax.lax.with_sharding_constraint(p, mat_sharding)

        take_step = get_exponential_take_step(magnus_order, expm_func=expm_func)

        @jax.jit
        def run(y):
            res = fixed_step_solver_template_jax(
                take_step, sharded_generator, t_span, y, max_dt, t_eval=t_eval
            )
            # frame-BASIS conversion on device so the result stays sharded
            return results_y_out_of_frame_basis(model, res.y, jnp.ndim(y))

        ys = run(jax.device_put(y0_fb, y_sharding))
        t_merged = np.asarray(merge_t_args(t_span, t_eval))
        t_out = t_merged[1:-1] if t_eval is not None else t_merged
        return OdeResult(t=t_out, y=ys)
    finally:
        model.in_frame_basis = prev_flag
