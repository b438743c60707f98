"""Fused linear combination Sigma_j c_j G_j — the single hottest primitive.

Reference analog: ``/root/reference/qiskit_dynamics/arraylias/register_functions/linear_combo.py``
(``tensordot(coeffs, mats, axes=1)``).

Signal coefficients are real while operator stacks are complex. A naive
tensordot promotes the coefficients to complex and XLA then performs 4
real matmuls; splitting the operators into real/imag parts instead costs 2
real contractions. We do the split whenever the coefficient dtype is real.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax.experimental import sparse as jsparse

from ..unified import unp

__all__ = ["linear_combo", "linear_combo_bcoo"]


def linear_combo(coeffs, mats):
    """Evaluate ``Sigma_j coeffs[j] * mats[j]`` with ``mats`` a ``(k, ...)`` stack.

    Supports leading batch axes on ``coeffs``: ``(..., k) x (k, n, n) -> (..., n, n)``.
    """
    coeffs = unp.asarray(coeffs)
    mats = unp.asarray(mats)
    if not np.iscomplexobj(coeffs) and np.iscomplexobj(mats):
        real = unp.tensordot(coeffs, mats.real, axes=1)
        imag = unp.tensordot(coeffs, mats.imag, axes=1)
        return jax_lazy_complex(real, imag)
    return unp.tensordot(coeffs, mats, axes=1)


def jax_lazy_complex(re, im):
    """Combine real/imag parts into a complex array."""
    return re + 1j * im


def linear_combo_bcoo(coeffs, bcoo_mats: jsparse.BCOO):
    """Sparse linear combination over a BCOO stack with ``n_batch=1``.

    ``coeffs`` ``(k,)``; ``bcoo_mats`` a ``(k, n, n)`` BCOO. Returns a BCOO
    ``(n, n)`` (reference analog: broadcast-multiply-sum,
    ``linear_combo.py:46-50``).
    """
    coeffs = jnp.asarray(coeffs)
    # scale each batch element's data by its coefficient, then sum over batch
    scaled = jsparse.BCOO(
        (bcoo_mats.data * coeffs[(...,) + (None,) * (bcoo_mats.data.ndim - 1)], bcoo_mats.indices),
        shape=bcoo_mats.shape,
        indices_sorted=bcoo_mats.indices_sorted,
        unique_indices=bcoo_mats.unique_indices,
    )
    return jsparse.bcoo_reduce_sum(scaled, axes=(0,))
