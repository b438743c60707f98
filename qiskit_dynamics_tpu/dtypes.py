"""Precision configuration.

The framework keeps a single JAX core (the reference instead dispatches over
numpy/scipy/jax/jax-sparse via arraylias, ``/root/reference/qiskit_dynamics/arraylias/alias.py``).
Precision is global-by-default and follows ``jax_enable_x64``:

- x64 enabled (CPU validation runs): complex128 / float64 — matches the
  reference test bar of 1e-8 agreement.
- x64 disabled (GPU production runs): complex64 / float32, with accuracy-
  critical reductions carried out in float32 via ``preferred_element_type``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

ArrayLike = jax.typing.ArrayLike

# An unpinned float32 matmul may run in TF32 on the GPU's tensor cores (10
# mantissa bits); for quantum dynamics that turns near-identity propagator
# products into ~1e-3/step errors. Force full-f32 products by default; users
# can still lower precision per-op via the ``precision=`` argument or
# ``jax.default_matmul_precision``.
if jax.config.jax_default_matmul_precision is None:
    jax.config.update("jax_default_matmul_precision", "highest")


def default_float():
    """Default real dtype under the active x64 setting."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def default_complex():
    """Default complex dtype under the active x64 setting."""
    return jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64


def asarray(x, dtype=None):
    """jnp.asarray with None passthrough."""
    if x is None:
        return None
    return jnp.asarray(x, dtype=dtype)
