r"""Accurate f32 phase evaluation: ``(w * t) mod 2pi`` without precision loss.

The fused engines evaluate frame/carrier phases ``cos(w t)`` at absolute
times: at ``w t ~ 600`` rad (3-transmon serving configs reach this within one
schedule) a plain f32 product carries ``ulp(600) ~ 6e-5`` rad of error before
the trig function ever runs — a ~1e-4 accuracy floor for the dim-27 fused
serving path. This module removes that floor:

- time is tracked as an unevaluated f32 pair ``(t_hi, t_lo)`` (double-float,
  ~2^-48 relative — see :mod:`.df32` for the EFT primitives);
- the product ``w * t`` is formed with an error-free two-product;
- the result is reduced mod ``2pi`` Cody-Waite style, with the ``m * 2pi``
  term ALSO formed as an EFT product (a classic 3-constant Cody-Waite needs
  every ``m * c_k`` product exact, which fails for f32 once
  ``m * significand`` exceeds 24 bits; the EFT form has no such limit).

Absolute phase error after reduction: a few f32 ulps of the reduced value
(~5e-7 rad for phases up to ~1e5 rad), independent of ``|w t|``.

Everything here is straight-line jnp on f32 — safe inside the Pallas Triton
kernel (the only non-arithmetic ops are the int32 bitcasts of the df32 split)
and in plain XLA code. All helpers are no-ops conceptually in f64 (callers gate on
dtype and skip reduction under x64, where plain products are already exact
enough).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .df32 import two_sum, two_prod, _quick_two_sum

__all__ = [
    "split_const",
    "const_df",
    "time_add",
    "time_add_df",
    "reduced_phase",
    "TWO_PI_HI",
    "TWO_PI_LO",
]

_TWO_PI = 2.0 * np.pi
TWO_PI_HI = float(np.float32(_TWO_PI))
TWO_PI_LO = float(np.float32(_TWO_PI - np.float64(TWO_PI_HI)))
_INV_TWO_PI = float(np.float32(1.0 / _TWO_PI))


def split_const(x: float) -> tuple:
    """Host-side exact split of a python float into an f32 (hi, lo) pair."""
    hi = float(np.float32(x))
    lo = float(np.float32(np.float64(x) - np.float64(hi)))
    return hi, lo


def const_df(x: float) -> tuple:
    """:func:`split_const` as traced f32 scalars (for use inside kernels)."""
    hi, lo = split_const(x)
    return jnp.float32(hi), jnp.float32(lo)


def time_add(t_pair, dt):
    """(t_hi, t_lo) + f32 ``dt`` -> new normalized (hi, lo) pair."""
    s, e = two_sum(t_pair[0], dt)
    return _quick_two_sum(s, e + t_pair[1])


def time_add_df(a_pair, b_pair):
    """(hi, lo) + (hi, lo) -> normalized (hi, lo) (cheap df add: the inputs
    here are times, same sign and far from cancellation)."""
    s, e = two_sum(a_pair[0], b_pair[0])
    return _quick_two_sum(s, e + (a_pair[1] + b_pair[1]))


def step_time_df(idx_f, dt_pair, off_pair):
    """``idx * dt + off`` as an f32 (hi, lo) pair, EFT-exact products.

    ``idx_f`` is the (f32) step index; ``dt_pair``/``off_pair`` come from
    :func:`split_const` of the host-f64 step size and offset.
    """
    p, e = two_prod(idx_f, jnp.float32(dt_pair[0]))
    e = e + idx_f * jnp.float32(dt_pair[1])
    hi, lo = two_sum(p, jnp.float32(off_pair[0]))
    return _quick_two_sum(hi, lo + (e + jnp.float32(off_pair[1])))


def split_array(w) -> tuple:
    """Host-side exact split of a float64 numpy array into f32 (hi, lo).

    MUST run before any jit boundary: without x64, JAX casts f64 inputs to
    f32 at the call boundary, which destroys exactly the bits the lo part
    preserves. The frequency REPRESENTATION error alone (``w * 2^-24 * t``)
    reaches ~1e-3 rad at ``w t ~ 2e4`` — larger than the product-rounding
    error the mod-2pi reduction removes, so both halves matter.
    """
    w = np.asarray(w, dtype=np.float64)
    hi = w.astype(np.float32)
    lo = (w - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def reduced_phase(w_pair, t_pair):
    """``(w * t) mod 2pi`` in f32, accurate to a few ulps of the result.

    ``w_pair`` is an (w_hi, w_lo) f32 pair (elementwise arrays; pass
    ``(w, zeros)`` if only an f32 value exists); ``t_pair`` is the
    (t_hi, t_lo) time pair. The returned value lies in ``[-pi-eps, pi+eps]``
    — directly suitable for ``cos``/``sin``.
    """
    w_hi, w_lo = w_pair
    t_hi, t_lo = t_pair
    p, e = two_prod(w_hi, t_hi)
    # cross terms are O(|p| 2^-24): plain f32 products suffice (their own
    # rounding is O(|p| 2^-48), below the reduction's ulp floor)
    e = e + (w_hi * t_lo + w_lo * t_hi)
    m = jnp.floor(p * _INV_TWO_PI + 0.5)
    mp, me = two_prod(m, jnp.float32(TWO_PI_HI))
    # p - mp is exact (operands within a factor ~2 after reduction);
    # remaining terms are O(1) or smaller, ordinary f32 adds suffice
    return ((p - mp) + e) - (me + m * jnp.float32(TWO_PI_LO))
