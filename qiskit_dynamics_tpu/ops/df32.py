r"""Double-float32 ("df32") arithmetic for 1e-8-class accuracy from float32.

The production path runs with x64 off. The reference hits its 1e-8
cross-method agreement bar (``test/dynamics/common.py`` upstream)
by running float64 on CPU; the float32 equivalent implemented here is
*compensated arithmetic*: every value is an unevaluated sum ``hi + lo`` of
two float32s
(~49 bits of effective mantissa, unit roundoff ~2^-48 = 3.6e-15), and the
primitive operations use error-free transformations (Knuth two_sum; a
two_prod built from exact 12-bit bitmask splits) so no rounding error is
silently dropped.

Rules of use:

- A df number is a plain ``(hi, lo)`` tuple of same-shape float32 arrays with
  ``|lo| <= ulp(hi)/2`` (normalized). Complex values are ``(re, im)`` pairs
  of df numbers — see the ``c*`` helpers.
- All ops are elementwise and broadcast like jnp; everything is jit-safe.
- Correctness requires exactly-rounded f32 add/mul WITHOUT reassociation,
  and tolerates FMA contraction by construction (see the CONTRACTION
  IMMUNITY note below); ``tests/test_df32.py`` fails loudly if a backend
  still breaks the contract.
- Constants/inputs available in f64 on host enter via :func:`from_f64`
  (exact split); device-side f32 values enter via :func:`from_f32`
  (lo = 0).

The intended consumers are the high-precision solver paths
(``ops/df_sweep.py``): trig/phase tables are precomputed on host in f64 and
shipped as df pairs, so device code needs only +,-,* — the three operations
this module makes ~1e-15-accurate.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "two_sum",
    "two_prod",
    "from_f64",
    "from_f32",
    "to_f64",
    "add",
    "sub",
    "neg",
    "mul",
    "add_f32",
    "mul_f32",
    "cadd",
    "csub",
    "cmul",
    "cneg",
    "cmul_real",
    "cfrom_f64",
    "cto_f64",
]

_f32 = jnp.float32


def _as32(a):
    return jnp.asarray(a, dtype=_f32)


# CONTRACTION IMMUNITY. XLA's LLVM backends may contract `a*b + c` into
# fma(a, b, c) inside fusions (optimization_barrier and bitcast round-trips
# do NOT stop it on XLA:CPU). fma changes the
# rounding of any fadd fed by an inexact fmul, which breaks classic
# Dekker/Veltkamp EFTs (they rely on fl(a*b) being formed separately).
# The algorithms below are therefore written so that EVERY product whose
# rounding matters is EXACT (operands hold <= 12 significand bits after a
# bitmask split, so the 24-bit product is representable): contracting an
# exact product into an add leaves the result bit-identical. Inexact
# products appear only in O(eps^2) correction terms where a 1-ulp change
# is harmless. tests/test_df32.py fails loudly if a backend still breaks
# the contract.


def two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly, s = fl(a + b). 6 flops."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _quick_two_sum(a, b):
    """Fast two-sum; requires |a| >= |b| (or a == 0). 3 flops."""
    s = a + b
    e = b - (s - a)
    return s, e


_HI_MASK = np.int32(np.uint32(0xFFFFF000).view(np.int32))


def _bitmask_split(a):
    """Split a into hi + lo exactly, hi holding 12 significand bits.

    Pure bit surgery (truncate the low 12 stored-mantissa bits) — involves
    no FP rounding at all, unlike the Veltkamp split whose correctness
    depends on fl(4097*a) not being FMA-contracted. lo = a - hi is exact
    (it reproduces the truncated bits).

    Scalars and 1-d values are lifted to (1, n) around the bit ops (the
    Triton kernel's scalar loads take the same path; the arithmetic is
    unchanged)."""
    ndim = jnp.ndim(a)
    av = jnp.reshape(a, (1, -1)) if ndim < 2 else a
    hi = jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(av, jnp.int32) & _HI_MASK, jnp.float32
    )
    if ndim < 2:
        hi = jnp.reshape(hi, jnp.shape(a))
    return hi, a - hi


def two_prod(a, b):
    """Two-product: p + e == a * b + O(eps^2 ulp). ~22 flops + bit ops.

    All four partial products of the 12-bit splits are exact f32 values,
    so the combination below is a chain of EFT adds on exact inputs —
    immune to FMA contraction by construction."""
    ah, al = _bitmask_split(a)
    bh, bl = _bitmask_split(b)
    t, e1 = two_sum(ah * bl, al * bh)
    p, e2 = two_sum(ah * bh, t)
    e = (e1 + e2) + al * bl
    return _quick_two_sum(p, e)


# ---------------------------------------------------------------------------
# conversions


def from_f64(a) -> tuple:
    """Host-side exact split of a float64 array into a df pair (numpy)."""
    a = np.asarray(a, dtype=np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def from_f32(a) -> tuple:
    """Lift an f32 array into a df pair (lo = 0)."""
    a = _as32(a)
    return a, jnp.zeros_like(a)


def to_f64(x) -> np.ndarray:
    """Host-side recombination into float64 (numpy). Forces a transfer."""
    return np.asarray(x[0], dtype=np.float64) + np.asarray(x[1], dtype=np.float64)


# ---------------------------------------------------------------------------
# real df arithmetic


def add(x, y):
    """df + df (accurate/IEEE double-double add). 20 flops.

    The cheaper 'sloppy' variant loses digits under cancellation — measured
    ~1e-12 per expm-Horner step vs ~1e-15 for this version — and propagator
    chains hit cancellation constantly (commutators, oscillating phases)."""
    s1, s2 = two_sum(x[0], y[0])
    t1, t2 = two_sum(x[1], y[1])
    s2 = s2 + t1
    s1, s2 = _quick_two_sum(s1, s2)
    s2 = s2 + t2
    return _quick_two_sum(s1, s2)


def neg(x):
    return (-x[0], -x[1])


def sub(x, y):
    s1, s2 = two_sum(x[0], -y[0])
    t1, t2 = two_sum(x[1], -y[1])
    s2 = s2 + t1
    s1, s2 = _quick_two_sum(s1, s2)
    s2 = s2 + t2
    return _quick_two_sum(s1, s2)


def mul(x, y):
    """df * df. 24 flops."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return _quick_two_sum(p, e)


def add_f32(x, a):
    """df + f32. 9 flops."""
    s, e = two_sum(x[0], a)
    e = e + x[1]
    return _quick_two_sum(s, e)


def mul_f32(x, a):
    """df * f32. 20 flops."""
    p, e = two_prod(x[0], a)
    e = e + x[1] * a
    return _quick_two_sum(p, e)


# ---------------------------------------------------------------------------
# complex df: value = (re, im), each a df pair


def cfrom_f64(a) -> tuple:
    """Host-side split of a complex128 array into ((re_hi, re_lo), (im_hi, im_lo))."""
    a = np.asarray(a, dtype=np.complex128)
    return from_f64(a.real), from_f64(a.imag)


def cto_f64(z) -> np.ndarray:
    """Host-side recombination into complex128 (numpy)."""
    return to_f64(z[0]) + 1j * to_f64(z[1])


def cadd(a, b):
    return add(a[0], b[0]), add(a[1], b[1])


def csub(a, b):
    return sub(a[0], b[0]), sub(a[1], b[1])


def cneg(a):
    return neg(a[0]), neg(a[1])


def cmul(a, b):
    """complex df * complex df: 4 real muls + 2 adds."""
    re = sub(mul(a[0], b[0]), mul(a[1], b[1]))
    im = add(mul(a[0], b[1]), mul(a[1], b[0]))
    return re, im


def cmul_real(a, x):
    """complex df * real df."""
    return mul(a[0], x), mul(a[1], x)
