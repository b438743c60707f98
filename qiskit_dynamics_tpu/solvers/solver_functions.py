"""``solve_ode`` / ``solve_lmde``: the functional solver interface.

Reference: ``/root/reference/qiskit_dynamics/solvers/solver_functions.py``.
Method table:

ODE methods (``dy/dt = f(t, y)``):
- scipy (host): ``RK45, RK23, BDF, DOP853, Radau, LSODA`` or an ``OdeSolver``
  subclass
- fixed-step: ``RK4`` (host), ``jax_RK4``
- adaptive under jit: ``jax_odeint`` (jax.experimental.ode bridge),
  ``tpu_dopri5`` / ``tpu_dop853`` (native bounded-scan steppers — the
  default; ``jax_dopri5``/``jax_dop853`` are accepted aliases)

LMDE methods (``dy/dt = G(t) y``):
- ``scipy_expm``, ``jax_expm`` (fixed-step Magnus 1/2/3 exponential)
- ``lanczos_diag``, ``jax_lanczos_diag`` (Krylov expm action)
- ``jax_expm_parallel``, ``jax_RK4_parallel`` (vmap + associative_scan)
- ``tensor_expm`` (Hilbert-space-sharded fixed-step Magnus over a
  ``"model"`` mesh axis; requires ``mesh=`` — see ``parallel/tensor.py``)

Models are flipped into the frame eigenbasis for solving (diagonal-phase
transforms instead of dense basis changes per step) and results rotated back —
the frame-basis fast path (reference ``solver_functions.py:376-450``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union
from warnings import warn

import numpy as np
import jax.numpy as jnp
from scipy.integrate import OdeSolver

from ..exceptions import DynamicsError
from ..unified import unp
from ..utils.metrics import solve_span
from ..models import BaseGeneratorModel, GeneratorModel, HamiltonianModel, LindbladModel
from .results import OdeResult
from .solver_utils import is_lindblad_model_not_vectorized
from .fixed_step_solvers import (
    RK4_solver,
    jax_RK4_solver,
    scipy_expm_solver,
    jax_expm_solver,
    lanczos_diag_solver,
    jax_lanczos_diag_solver,
    jax_expm_parallel_solver,
    jax_RK4_parallel_solver,
)
from .scipy_solve_ivp import scipy_solve_ivp, SOLVE_IVP_METHODS
from .jax_odeint import jax_odeint
from .adaptive import tpu_dopri5, tpu_dop853
from .diffrax_solver import diffrax_solver, _is_diffrax_method

__all__ = ["solve_ode", "solve_lmde", "ODE_METHODS", "LMDE_METHODS"]

_TPU_ADAPTIVE = {
    "tpu_dopri5": tpu_dopri5,
    "jax_dopri5": tpu_dopri5,
    "tpu_dop853": tpu_dop853,
    "jax_dop853": tpu_dop853,
}

ODE_METHODS = (
    ["RK45", "RK23", "BDF", "DOP853", "Radau", "LSODA"]
    + ["RK4"]
    + ["jax_odeint", "jax_RK4"]
    + list(_TPU_ADAPTIVE)
)
LMDE_METHODS = [
    "scipy_expm",
    "lanczos_diag",
    "jax_lanczos_diag",
    "jax_expm",
    "jax_expm_parallel",
    "jax_RK4_parallel",
    "tensor_expm",
]


def _is_jax_method(method) -> bool:
    """Whether the method executes inside jax (jit-compatible)."""
    if _is_diffrax_method(method):
        return True
    return method in (
        ["jax_odeint", "jax_RK4", "jax_expm", "jax_expm_parallel", "jax_RK4_parallel",
         "jax_lanczos_diag"] + list(_TPU_ADAPTIVE)
    )


def _lanczos_validation(rhs, t_span, y0, k_dim):
    if isinstance(rhs, BaseGeneratorModel):
        if not isinstance(rhs, HamiltonianModel):
            raise DynamicsError(
                "Lanczos solvers can only be used for HamiltonianModel or function-based "
                "anti-Hermitian generators."
            )
        if rhs.array_library is None or "sparse" not in str(rhs.array_library):
            warn(
                "lanczos_diag should be used with a generator in sparse mode for better "
                "performance.",
                stacklevel=2,
            )
    dim = np.asarray(rhs(np.asarray(t_span)[0])).shape[0] if not isinstance(
        rhs, BaseGeneratorModel
    ) else rhs.dim
    if k_dim > dim:
        raise DynamicsError("k_dim can be no larger than the dimension of the generator.")
    if jnp.ndim(y0) not in (1, 2):
        raise DynamicsError("y0 must be 1d or 2d.")


def _validate_not_scipy_sparse_under_jax(method, model):
    """``jax_*``/``tpu_*``/``fused_*`` methods trace the model; scipy-sparse evaluation cannot run
    under a tracer — fail loudly instead of leaking a TracerArrayConversionError
    (use ``array_library="jax_sparse"`` for sparse evaluation under jax)."""
    if (
        isinstance(method, str)
        and method.startswith(("jax_", "tpu_", "fused_"))
        and isinstance(model, BaseGeneratorModel)
        and getattr(model, "array_library", None) == "scipy_sparse"
    ):
        raise DynamicsError(
            f"method {method!r} traces the generator under jax and cannot "
            'evaluate a scipy_sparse model; use array_library="jax_sparse" '
            "for sparse evaluation under jax, or a numpy-path method "
            "(e.g. lanczos_diag, scipy_expm, DOP853)."
        )


def solve_ode(
    rhs: Union[Callable, BaseGeneratorModel],
    t_span,
    y0,
    method: Union[str, type] = "DOP853",
    t_eval=None,
    **kwargs,
) -> OdeResult:
    r"""Solve ``dy/dt = f(t, y)``. See module docstring for available methods."""
    if (
        method not in ODE_METHODS
        and not (isinstance(method, type) and issubclass(method, OdeSolver))
        and not _is_diffrax_method(method)
    ):
        raise DynamicsError(f"Method {method} not supported by solve_ode.")

    _validate_not_scipy_sparse_under_jax(method, rhs)

    if isinstance(rhs, BaseGeneratorModel):
        _, solver_rhs, y0, model_in_frame_basis = setup_generator_model_rhs_y0_in_frame_basis(
            rhs, y0
        )
    else:
        solver_rhs = rhs

    with solve_span(f"solve_ode[{method}]", method=str(method)):
        if method in SOLVE_IVP_METHODS or (
            isinstance(method, type) and issubclass(method, OdeSolver)
        ):
            results = scipy_solve_ivp(
                solver_rhs, t_span, np.asarray(y0), method, t_eval=t_eval, **kwargs
            )
        elif method == "RK4":
            results = RK4_solver(solver_rhs, t_span, np.asarray(y0), t_eval=t_eval, **kwargs)
        elif method == "jax_RK4":
            results = jax_RK4_solver(solver_rhs, t_span, unp.asarray(y0), t_eval=t_eval, **kwargs)
        elif method == "jax_odeint":
            results = jax_odeint(solver_rhs, t_span, unp.asarray(y0), t_eval=t_eval, **kwargs)
        elif method in _TPU_ADAPTIVE:
            results = _TPU_ADAPTIVE[method](
                solver_rhs, t_span, unp.asarray(y0, dtype=complex), t_eval=t_eval, **kwargs
            )
        elif _is_diffrax_method(method):
            results = diffrax_solver(
                solver_rhs, t_span, unp.asarray(y0, dtype=complex), method,
                t_eval=t_eval, **kwargs,
            )

    if isinstance(rhs, BaseGeneratorModel):
        if not model_in_frame_basis:
            results.y = results_y_out_of_frame_basis(rhs, results.y, jnp.ndim(y0))
        rhs.in_frame_basis = model_in_frame_basis

    return results


def solve_lmde(
    generator: Union[Callable, BaseGeneratorModel],
    t_span,
    y0,
    method: Union[str, type] = "DOP853",
    t_eval=None,
    **kwargs,
) -> OdeResult:
    r"""Solve ``dy/dt = G(t) y``. See module docstring for available methods."""
    if (
        method in ODE_METHODS
        or (isinstance(method, type) and issubclass(method, OdeSolver))
        or _is_diffrax_method(method)
    ):
        if isinstance(generator, BaseGeneratorModel):
            rhs = generator
        else:
            def rhs(t, y):
                return generator(t) @ y

        return solve_ode(rhs, t_span, y0, method=method, t_eval=t_eval, **kwargs)

    if method not in LMDE_METHODS:
        raise DynamicsError(f"Method {method} not supported by solve_lmde.")

    if is_lindblad_model_not_vectorized(generator):
        raise DynamicsError(
            "LMDE-specific methods with LindbladModel requires setting vectorized=True."
        )

    _validate_not_scipy_sparse_under_jax(method, generator)

    if method == "tensor_expm":
        # Hilbert-space-sharded fixed-step Magnus solve: dispatch to the
        # parallel layer (it owns the frame setup) — see parallel/tensor.py
        from ..parallel.tensor import tensor_magnus_solve

        if not isinstance(generator, BaseGeneratorModel):
            raise DynamicsError(
                'method="tensor_expm" requires a model generator (it shards '
                "the model's operators over the mesh)."
            )
        if "mesh" not in kwargs:
            raise DynamicsError(
                'method="tensor_expm" requires mesh= (a jax.sharding.Mesh '
                'with a "model" axis; see parallel.model_mesh).'
            )
        return tensor_magnus_solve(
            generator, t_span, y0, kwargs.pop("mesh"), t_eval=t_eval, **kwargs
        )

    if isinstance(generator, BaseGeneratorModel):
        solver_generator, _, y0, model_in_frame_basis = (
            setup_generator_model_rhs_y0_in_frame_basis(generator, y0)
        )
    else:
        solver_generator = generator

    y0_ndim = jnp.ndim(y0)
    with solve_span(f"solve_lmde[{method}]", method=str(method)):
        if method == "scipy_expm":
            results = scipy_expm_solver(
                solver_generator, t_span, np.asarray(y0), t_eval=t_eval, **kwargs
            )
        elif method == "lanczos_diag":
            _lanczos_validation(generator, t_span, y0, kwargs["k_dim"])
            results = lanczos_diag_solver(
                solver_generator, t_span, np.asarray(y0), t_eval=t_eval, **kwargs
            )
        elif method == "jax_lanczos_diag":
            _lanczos_validation(generator, t_span, y0, kwargs["k_dim"])
            results = jax_lanczos_diag_solver(
                solver_generator, t_span, y0, t_eval=t_eval, **kwargs
            )
        elif method == "jax_expm":
            if isinstance(generator, BaseGeneratorModel) and generator.array_library is not None and (
                "sparse" in str(generator.array_library)
            ):
                raise DynamicsError("jax_expm cannot be used with a generator in sparse mode.")
            results = jax_expm_solver(solver_generator, t_span, y0, t_eval=t_eval, **kwargs)
        elif method == "jax_expm_parallel":
            results = jax_expm_parallel_solver(
                solver_generator, t_span, unp.asarray(y0, dtype=complex), t_eval=t_eval, **kwargs
            )
        elif method == "jax_RK4_parallel":
            results = jax_RK4_parallel_solver(
                solver_generator, t_span, unp.asarray(y0, dtype=complex), t_eval=t_eval, **kwargs
            )

    if isinstance(generator, BaseGeneratorModel):
        if not model_in_frame_basis:
            results.y = results_y_out_of_frame_basis(generator, results.y, y0_ndim)
        generator.in_frame_basis = model_in_frame_basis

    return results


def setup_generator_model_rhs_y0_in_frame_basis(
    generator_model: BaseGeneratorModel, y0
) -> Tuple[Callable, Callable, object, bool]:
    """Flip a model into the frame eigenbasis and transform y0 accordingly.

    Mutates ``generator_model.in_frame_basis`` (restored by the caller).
    """
    model_in_frame_basis = generator_model.in_frame_basis

    if not model_in_frame_basis:
        if is_lindblad_model_vectorized_helper(generator_model):
            if generator_model.rotating_frame.frame_basis is not None:
                y0 = generator_model.rotating_frame.vectorized_frame_basis_adjoint @ y0
        elif isinstance(generator_model, LindbladModel):
            y0 = generator_model.rotating_frame.operator_into_frame_basis(y0)
        elif isinstance(generator_model, GeneratorModel):
            y0 = generator_model.rotating_frame.state_into_frame_basis(y0)

    generator_model.in_frame_basis = True

    def generator(t):
        return generator_model(t)

    def rhs(t, y):
        return generator_model(t, y)

    return generator, rhs, y0, model_in_frame_basis


def is_lindblad_model_vectorized_helper(obj) -> bool:
    """True for a vectorized LindbladModel."""
    return isinstance(obj, LindbladModel) and obj.vectorized


def results_y_out_of_frame_basis(generator_model, results_y, y0_ndim: int):
    """Rotate a time-stacked result array out of the frame basis."""
    if y0_ndim == 1:
        results_y = results_y.T
    if is_lindblad_model_vectorized_helper(generator_model):
        if generator_model.rotating_frame.frame_basis is not None:
            results_y = generator_model.rotating_frame.vectorized_frame_basis @ results_y
    elif isinstance(generator_model, LindbladModel):
        results_y = generator_model.rotating_frame.operator_out_of_frame_basis(results_y)
    else:
        results_y = generator_model.rotating_frame.state_out_of_frame_basis(results_y)
    if y0_ndim == 1:
        results_y = results_y.T
    return results_y
