"""Host/trace unified array namespace.

``unp.<fn>(*args)`` dispatches to **numpy** when every argument is concrete and
to **jax.numpy** when any argument is a JAX tracer. Keeping all
construction-time math (frame eigendecompositions, operator-basis rotations,
sample manipulation) in numpy means model state is host-resident, in float64,
and gets baked into compiled executables as constants, while the same code
paths dispatch to ``jnp`` when traced inside ``jit``/``grad``/``vmap``.

This replaces the reference's 4-way arraylias dispatch
(``/root/reference/qiskit_dynamics/arraylias/alias.py``) with a single 2-way
host/trace rule.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["unp", "contains_tracer", "asarray"]


def contains_tracer(*args) -> bool:
    """Whether any (nested) argument is a JAX tracer.

    Recurses through lists, tuples, and dict values — a tracer hiding in a
    kwarg or nested container must flip dispatch to jnp, or the call lands
    in numpy and fails with a confusing conversion error."""
    for arg in args:
        if isinstance(arg, jax.core.Tracer):
            return True
        if isinstance(arg, (list, tuple)):
            if contains_tracer(*arg):
                return True
        elif isinstance(arg, dict):
            if contains_tracer(*arg.values()):
                return True
    return False


def _is_qobj(x) -> bool:
    return type(x).__name__ == "Qobj" and hasattr(x, "full")


def dequtip(x):
    """Coerce qutip ``Qobj`` values (duck-typed on ``.full()``) to arrays;
    everything else passes through. Applied at model-constructor boundaries
    (validation runs before the generic asarray conversion would)."""
    if _is_qobj(x):
        return x.full()
    if isinstance(x, (list, tuple)) and any(_is_qobj(e) for e in x):
        return [e.full() if _is_qobj(e) else e for e in x]
    return x


def asarray(x, dtype=None):
    """Concrete -> numpy array; traced -> jnp array.

    qutip ``Qobj`` inputs are coerced through ``.full()`` (duck-typed, no
    qutip dependency) — reference behavior:
    ``/root/reference/qiskit_dynamics/arraylias/register_functions/asarray.py:36-59``.
    Lists of Qobj coerce elementwise (operator lists).
    """
    x = dequtip(x)
    if contains_tracer(x):
        return jnp.asarray(x, dtype=dtype)
    return np.asarray(x, dtype=dtype)


class _Linalg:
    def __getattr__(self, name):
        def fn(*args, **kwargs):
            traced = contains_tracer(*args) or contains_tracer(kwargs)
            mod = jnp.linalg if traced else np.linalg
            return getattr(mod, name)(*args, **kwargs)

        return fn


class _Unified:
    """Attribute-forwarding dispatcher between numpy and jax.numpy."""

    linalg = _Linalg()

    @staticmethod
    def asarray(x, dtype=None):
        return asarray(x, dtype=dtype)

    def __getattr__(self, name):
        if not callable(getattr(np, name, None)):
            # constants (pi, inf, nan, newaxis, dtypes, ...)
            return getattr(np, name)

        def fn(*args, **kwargs):
            mod = jnp if contains_tracer(*args) or contains_tracer(kwargs) else np
            return getattr(mod, name)(*args, **kwargs)

        fn.__name__ = name
        return fn


unp = _Unified()
