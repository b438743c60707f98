"""Jit boundary utilities that carry complex values as real/imag pairs.

``cjit`` wraps ``jax.jit`` so that complex leaves of inputs are split into
real/imag pairs on the host, recombined inside the trace, and outputs are
split inside / recombined outside. JAX on CPU and GPU moves complex arrays
across the boundary directly, so this costs only a couple of cheap
elementwise ops; the public ``Solver``/backend paths still route through it.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["cjit", "encode_complex", "decode_complex", "to_host"]


def to_host(x):
    """Transfer a (possibly device) array to host numpy.

    Complex device arrays come over as real/imag copies recombined in numpy.
    Non-arrays and host values pass through."""
    if isinstance(x, jax.Array):
        if np.issubdtype(x.dtype, np.complexfloating):
            return np.asarray(jnp.real(x)) + 1j * np.asarray(jnp.imag(x))
        return np.asarray(x)
    return x

_RE_KEY = "__cplx_re__"
_IM_KEY = "__cplx_im__"


def _is_encoded(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {_RE_KEY, _IM_KEY}


def encode_complex(tree):
    """Replace complex array leaves with {re, im} dicts of real arrays."""

    def enc(x):
        if hasattr(x, "dtype") and np.issubdtype(x.dtype, np.complexfloating):
            if isinstance(x, jax.core.Tracer):
                return {_RE_KEY: jnp.real(x), _IM_KEY: jnp.imag(x)}
            # concrete values split on host
            x = np.asarray(x)
            return {_RE_KEY: np.ascontiguousarray(x.real), _IM_KEY: np.ascontiguousarray(x.imag)}
        return x

    return jax.tree_util.tree_map(enc, tree)


def decode_complex(tree):
    """Inverse of :func:`encode_complex`."""

    def dec(x):
        if _is_encoded(x):
            re, im = x[_RE_KEY], x[_IM_KEY]
            if isinstance(re, jax.core.Tracer):
                return re + 1j * im
            # concrete: combine on host
            return np.asarray(re) + 1j * np.asarray(im)
        return x

    return jax.tree_util.tree_map(dec, tree, is_leaf=_is_encoded)


def cjit(fn=None, **jit_kwargs):
    """``jax.jit`` with complex-safe input/output boundaries.

    Usage: ``cjit(f)`` or ``@cjit(static_argnums=...)``.
    """
    if fn is None:
        return functools.partial(cjit, **jit_kwargs)

    @jax.jit
    def _inner(enc_args, enc_kwargs):
        args = decode_complex(enc_args)
        kwargs = decode_complex(enc_kwargs)
        out = fn(*args, **kwargs)
        return encode_complex(out)

    if jit_kwargs:
        # re-wrap with user jit kwargs (static args refer to the packed tree)
        _inner = jax.jit(_inner.__wrapped__, **jit_kwargs)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        enc_args = encode_complex(args)
        enc_kwargs = encode_complex(kwargs)
        out = _inner(enc_args, enc_kwargs)
        return decode_complex(out)

    return wrapper
