r"""Branch-free batched matrix exponentials for the fixed-step hot path.

``jax.scipy.linalg.expm`` selects among five Pade orders with ``lax.cond`` and
runs a dynamic squaring loop; under ``vmap`` the conds become ``select``\s and
EVERY branch is computed, and for small dims the many small operations
dominate wall-clock (batched-expm cost is per-op overhead, not FLOPs). For
fixed-step solvers the step generators have a KNOWN norm
bound (``max_dt`` times a generator scale), so a fixed-order Taylor with a
static number of squarings is exact to working precision with a fraction of
the operations — and the polynomial is evaluated Paterson-Stockmeyer style,
so a degree-12 Taylor costs 5 matmuls instead of Horner's 11 (matmuls are
the entire cost at dim >= 64).

Error bound: for ``theta = ||A|| / 2**squarings``, the truncation error is
``~ theta**(order+1) / (order+1)!``; the default (order=12, squarings=2)
gives < 1e-12 relative error for ``||A|| <= 4`` — far below complex64
round-off, and matching float64 tolerances used in the tests.
"""
from __future__ import annotations

import math

import jax.numpy as jnp

__all__ = ["expm_taylor"]


def expm_taylor(A, order: int = 12, squarings: int = 2):
    """Batched ``expm`` via fixed-order Taylor + static scaling-and-squaring.

    The Taylor polynomial is evaluated with Paterson-Stockmeyer blocking
    (powers up to ``X^s`` with ``s ~ sqrt(order)``, then Horner in ``X^s``):
    ``(s - 1) + ceil((order + 1) / s) - 1`` matmuls instead of Horner's
    ``order - 1`` — e.g. 5 instead of 11 at the default order 12. The
    polynomial is mathematically identical; only the (stable) evaluation
    order differs.

    Args:
        A: (..., n, n) array (any leading batch dims).
        order: Taylor order.
        squarings: static number of scaling/squaring steps; accurate while
            ``norm(A) / 2**squarings`` stays of order one.

    Returns:
        (..., n, n) matrix exponentials.
    """
    n = A.shape[-1]
    eye = jnp.eye(n, dtype=A.dtype)
    X = A / (2.0**squarings)

    if order < 6:
        # small orders: plain Horner (PS blocking saves nothing here)
        P = eye + X / order
        for k in range(order - 1, 0, -1):
            P = eye + (X @ P) / k
    else:
        s = max(2, math.isqrt(order))
        # powers[i] = X^i for i = 0..s  ->  (s - 1) matmuls
        powers = [eye, X]
        for _ in range(2, s + 1):
            powers.append(powers[-1] @ X)
        Xs = powers[s]

        coeff = [1.0 / math.factorial(k) for k in range(order + 1)]

        def block(j):
            """B_j = sum_i c_{js+i} X^i (i < s): scalar-matrix combos, no matmul."""
            out = None
            for i in range(s):
                k = s * j + i
                if k > order:
                    break
                term = coeff[k] * powers[i]
                out = term if out is None else out + term
            return out

        m = -(-(order + 1) // s) - 1  # index of the top block
        top = block(m)
        # top block of the form c*I: fold into the first Horner step for free
        if s * m == order:
            P = block(m - 1) + coeff[order] * Xs
            m -= 1
        else:
            P = top
        for j in range(m - 1, -1, -1):
            P = block(j) + Xs @ P

    for _ in range(squarings):
        P = P @ P
    return P
