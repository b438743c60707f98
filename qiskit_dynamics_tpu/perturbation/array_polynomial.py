r"""Multivariable array-valued polynomials.

Reference behavior: ``/root/reference/qiskit_dynamics/perturbation/array_polynomial.py``.

Represents :math:`f(c) = A_\emptyset + \sum_{I \in S} c_I A_I` with multiset
monomial labels. Design difference from the reference: monomial evaluation is
**not** recursive — labels are compiled host-side into one padded index matrix
and monomials are computed on device as a single gather + axis-product
(``prod(c_ext[label_matrix], axis=1)``), one fused elementwise kernel with
no sequential dependency chain. Polynomial evaluation is then a single
``tensordot`` onto the stacked coefficient tensor.

Algebraic operations (add / mul / matmul, with optional monomial filtering for
degree truncation) compile sparse product rules host-side and execute through
:mod:`.custom_dot`.
"""
from __future__ import annotations

from itertools import product as _iter_product
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from ..exceptions import DynamicsError
from ..unified import contains_tracer
from .custom_dot import _CustomBinaryOp
from .multiset_utils import (
    Multiset,
    sorted_multisets,
    submultisets_and_complements,
    to_multiset,
)

__all__ = ["ArrayPolynomial"]


def _is_arraylike(x) -> bool:
    return isinstance(x, (int, float, complex, list, tuple, np.ndarray, jax.Array)) and not isinstance(
        x, ArrayPolynomial
    )


def _compile_monomial_indices(labels: List[Multiset]) -> Tuple[np.ndarray, int]:
    """Pad labels into an (M, Lmax) index matrix; sentinel index = n_vars slot
    that is filled with 1.0 at evaluation time. Returns (matrix, max_len)."""
    max_len = max(len(l) for l in labels)
    n_vars_sentinel = -1  # resolved at call time against c's length
    mat = np.full((len(labels), max_len), n_vars_sentinel, dtype=int)
    for i, label in enumerate(labels):
        mat[i, : len(label)] = label
    return mat, max_len


class ArrayPolynomial:
    r"""A polynomial with array-valued coefficients.

    :math:`f(c) = A_\emptyset + \sum_I c_I A_I` where for a multiset
    :math:`I = (i_1, ..., i_k)`, :math:`c_I = c_{i_1} \cdots c_{i_k}`.

    Instantiated with ``constant_term`` (:math:`A_\emptyset`),
    ``array_coefficients`` (stacked :math:`A_I`), and ``monomial_labels``
    (multisets in any coercible form). Supports evaluation ``ap(c)``,
    array-like methods (``conj``, ``transpose``, ``trace``, ``sum``, ``real``,
    indexing), and algebra (``+``, ``*``, ``@``; ``add``/``mul``/``matmul``
    with a ``monomial_filter`` for degree truncation).
    """

    __array_priority__ = 20

    def __init__(
        self,
        constant_term=None,
        array_coefficients=None,
        monomial_labels: Optional[List] = None,
        array_library: Optional[str] = None,
    ):
        if array_coefficients is None and constant_term is None:
            raise DynamicsError(
                "At least one of array_coefficients and constant_term must be specified."
            )

        # reference-compat kwarg (ref array_polynomial.py:139,169): under the
        # one-JAX-core design "numpy"/"jax" need no storage conversion;
        # "jax"/"jax_sparse" force jnp storage so evaluation stays on device
        if array_library is not None:
            if array_library not in ("numpy", "jax", "jax_sparse", "scipy_sparse"):
                raise DynamicsError(f"Unsupported array_library {array_library!r}.")
            if array_library == "scipy_sparse":
                # the reference keeps scipy-sparse coefficient storage; the
                # one-JAX-core build densifies — warn rather than silently
                # blow up memory on large sparse terms
                import warnings

                warnings.warn(
                    "ArrayPolynomial stores coefficients dense in this build; "
                    "array_library='scipy_sparse' inputs are densified "
                    "(O(n^2) per term).",
                    stacklevel=2,
                )
                densify = lambda x: (
                    x.toarray()
                    if hasattr(x, "toarray")
                    else [e.toarray() if hasattr(e, "toarray") else e for e in x]
                    if isinstance(x, (list, tuple))
                    else x
                )
                if array_coefficients is not None:
                    array_coefficients = densify(array_coefficients)
                if constant_term is not None:
                    constant_term = densify(constant_term)
            if "jax" in array_library:
                if array_coefficients is not None:
                    array_coefficients = jnp.asarray(array_coefficients)
                if constant_term is not None:
                    constant_term = jnp.asarray(constant_term)

        if monomial_labels is not None:
            self._monomial_labels = [to_multiset(m) for m in monomial_labels]
        else:
            self._monomial_labels = []

        if array_coefficients is not None and len(self._monomial_labels) != len(
            array_coefficients
        ):
            raise DynamicsError(
                "array_coefficients and monomial_labels must have matching lengths."
            )

        self._array_coefficients = None
        if array_coefficients is not None:
            if contains_tracer(array_coefficients) or isinstance(array_coefficients, jax.Array):
                self._array_coefficients = jnp.asarray(array_coefficients)
            else:
                self._array_coefficients = np.asarray(array_coefficients)

        self._constant_term = None
        if constant_term is not None:
            if contains_tracer(constant_term) or isinstance(constant_term, jax.Array):
                self._constant_term = jnp.asarray(constant_term)
            else:
                self._constant_term = np.asarray(constant_term)

        if self._monomial_labels:
            self._index_matrix, self._max_degree = _compile_monomial_indices(
                self._monomial_labels
            )
        else:
            self._index_matrix, self._max_degree = None, 0

    @property
    def monomial_labels(self) -> List[Multiset]:
        """Multiset labels of the non-constant terms (canonical sorted tuples)."""
        return self._monomial_labels

    @property
    def array_coefficients(self):
        """Stacked coefficient arrays for non-constant terms."""
        return self._array_coefficients

    @property
    def constant_term(self):
        """The constant term."""
        return self._constant_term

    @property
    def shape(self) -> Tuple[int, ...]:
        if self._constant_term is not None:
            return self._constant_term.shape
        return self._array_coefficients.shape[1:]

    @property
    def ndim(self) -> int:
        if self._constant_term is not None:
            return self._constant_term.ndim
        return self._array_coefficients.ndim - 1

    def compute_monomials(self, c):
        """All monomial values :math:`c_I`, ordered as ``monomial_labels``.

        ``c`` may have trailing batch dimensions: shape ``(r, ...)`` produces
        monomials of shape ``(M, ...)``. One gather + product — no recursion.
        """
        if not self._monomial_labels:
            return None
        use_jax = contains_tracer(c) or isinstance(c, jax.Array)
        xp = jnp if use_jax else np
        c = xp.asarray(c)
        ones = xp.ones((1,) + c.shape[1:], dtype=c.dtype)
        c_ext = xp.concatenate([c, ones], axis=0)
        # sentinel -1 gathers the appended 1.0 row
        return xp.prod(c_ext[self._index_matrix], axis=1)

    def __call__(self, c=None):
        """Evaluate the polynomial at variable values ``c``."""
        if self._array_coefficients is None:
            return self._constant_term
        monomials = self.compute_monomials(c)
        use_jax = (
            contains_tracer(monomials)
            or isinstance(monomials, jax.Array)
            or isinstance(self._array_coefficients, jax.Array)
        )
        xp = jnp if use_jax else np
        val = xp.tensordot(xp.asarray(self._array_coefficients), monomials, axes=(0, 0))
        if self._constant_term is not None:
            val = self._constant_term + val
        return val

    # ------------------------------------------------------------------ #
    # array-like methods
    # ------------------------------------------------------------------ #

    def _map_terms(self, const_fn: Callable, coeff_fn: Callable) -> "ArrayPolynomial":
        const = const_fn(self._constant_term) if self._constant_term is not None else None
        coeffs = coeff_fn(self._array_coefficients) if self._array_coefficients is not None else None
        return ArrayPolynomial(
            constant_term=const,
            array_coefficients=coeffs,
            monomial_labels=list(self._monomial_labels),
        )

    def conj(self) -> "ArrayPolynomial":
        """Entrywise conjugate."""
        return self._map_terms(lambda a: a.conj(), lambda a: a.conj())

    def transpose(self, axes: Optional[Tuple[int, ...]] = None) -> "ArrayPolynomial":
        """Transpose all terms."""
        if axes is None:
            axes = tuple(range(self.ndim))[::-1]
        shifted = (0,) + tuple(ax + 1 for ax in axes)
        xp_t = lambda a, ax: (jnp if isinstance(a, jax.Array) else np).transpose(a, ax)
        return self._map_terms(lambda a: xp_t(a, axes), lambda a: xp_t(a, shifted))

    def trace(self, offset: int = 0, axis1: int = 0, axis2: int = 1, dtype=None) -> "ArrayPolynomial":
        """Trace of all terms."""
        if self.ndim < 2:
            raise DynamicsError("ArrayPolynomial.trace() requires ndim at least 2.")
        xp_tr = lambda a, a1, a2: (jnp if isinstance(a, jax.Array) else np).trace(
            a, offset=offset, axis1=a1, axis2=a2, dtype=dtype
        )
        return self._map_terms(
            lambda a: xp_tr(a, axis1, axis2), lambda a: xp_tr(a, axis1 + 1, axis2 + 1)
        )

    def sum(self, axis=None, dtype=None) -> "ArrayPolynomial":
        """Sum each term over ``axis``."""
        if axis is None:
            coeff_axis: Union[None, int, Tuple[int, ...]] = tuple(range(1, self.ndim + 1))
            if self.ndim == 0:
                coeff_axis = ()
        elif isinstance(axis, int):
            coeff_axis = axis + 1
        else:
            coeff_axis = tuple(a + 1 for a in axis)
        return self._map_terms(
            lambda a: a.sum(axis=axis, dtype=dtype),
            lambda a: a.sum(axis=coeff_axis, dtype=dtype),
        )

    @property
    def real(self) -> "ArrayPolynomial":
        """Real part of all terms."""
        return self._map_terms(lambda a: a.real, lambda a: a.real)

    def __getitem__(self, idx) -> "ArrayPolynomial":
        if not isinstance(idx, tuple):
            idx = (idx,)
        return self._map_terms(lambda a: a[idx], lambda a: a[(slice(None),) + idx])

    def __len__(self) -> int:
        n = 0
        if self._array_coefficients is not None:
            n += len(self._array_coefficients)
        if self._constant_term is not None:
            n += 1
        return n

    # ------------------------------------------------------------------ #
    # algebra
    # ------------------------------------------------------------------ #

    def add(self, other, monomial_filter: Optional[Callable] = None) -> "ArrayPolynomial":
        """Add, optionally keeping only terms whose label passes ``monomial_filter``."""
        if _is_arraylike(other):
            other = ArrayPolynomial(constant_term=other)
        if not isinstance(other, ArrayPolynomial):
            raise DynamicsError(
                "Only types castable as an ArrayPolynomial can be added to an ArrayPolynomial."
            )
        return _poly_add(self, other, monomial_filter)

    def matmul(self, other, monomial_filter: Optional[Callable] = None) -> "ArrayPolynomial":
        """Matmul, optionally truncating via ``monomial_filter``."""
        if _is_arraylike(other):
            other = ArrayPolynomial(constant_term=other)
        if not isinstance(other, ArrayPolynomial):
            raise DynamicsError(f"Type {type(other)} not supported by ArrayPolynomial.matmul.")
        return _poly_distributive_op(self, other, lambda a, b: a @ b, monomial_filter)

    def mul(self, other, monomial_filter: Optional[Callable] = None) -> "ArrayPolynomial":
        """Entrywise multiply, optionally truncating via ``monomial_filter``."""
        if _is_arraylike(other):
            other = ArrayPolynomial(constant_term=other)
        if not isinstance(other, ArrayPolynomial):
            raise DynamicsError(f"Type {type(other)} not supported by ArrayPolynomial.mul.")
        return _poly_distributive_op(self, other, lambda a, b: a * b, monomial_filter)

    def __add__(self, other):
        return self.add(other)

    def __radd__(self, other):
        return self.add(other)

    def __neg__(self):
        return self._map_terms(lambda a: -a, lambda a: -a)

    def __sub__(self, other):
        return self + (-other)

    def __rsub__(self, other):
        return (-self).add(other)

    def __mul__(self, other):
        return self.mul(other)

    def __rmul__(self, other):
        return self.mul(other)

    def __matmul__(self, other):
        return self.matmul(other)

    def __rmatmul__(self, other):
        if _is_arraylike(other):
            other = ArrayPolynomial(constant_term=other)
        if isinstance(other, ArrayPolynomial):
            return other.matmul(self)
        raise DynamicsError(f"Type {type(other)} not supported by ArrayPolynomial.__rmatmul__.")


def _poly_add(
    ap1: ArrayPolynomial, ap2: ArrayPolynomial, monomial_filter: Optional[Callable]
) -> ArrayPolynomial:
    for a, b in zip(ap1.shape[::-1], ap2.shape[::-1]):
        if not (a == 1 or b == 1 or a == b):
            raise DynamicsError("ArrayPolynomial addition requires broadcastable shapes.")
    if monomial_filter is None:
        monomial_filter = lambda _: True

    const = None
    if monomial_filter(()):
        if ap1.constant_term is not None and ap2.constant_term is not None:
            const = ap1.constant_term + ap2.constant_term
        elif ap1.constant_term is not None:
            const = ap1.constant_term
        elif ap2.constant_term is not None:
            const = ap2.constant_term

    if ap1.array_coefficients is None and ap2.array_coefficients is None:
        return ArrayPolynomial(constant_term=const)

    labels = sorted_multisets(
        {m for m in ap1.monomial_labels + ap2.monomial_labels if monomial_filter(m)}
    )
    idx1 = np.array([ap1.monomial_labels.index(m) if m in ap1.monomial_labels else -1 for m in labels] or [-1])
    idx2 = np.array([ap2.monomial_labels.index(m) if m in ap2.monomial_labels else -1 for m in labels] or [-1])

    use_jax = isinstance(ap1.array_coefficients, jax.Array) or isinstance(
        ap2.array_coefficients, jax.Array
    )
    xp = jnp if use_jax else np
    # each polynomial pads with its OWN shape; the final add broadcasts
    zero1 = xp.zeros((1,) + ap1.shape, dtype=complex)
    zero2 = xp.zeros((1,) + ap2.shape, dtype=complex)
    coeffs1 = (
        xp.concatenate([xp.asarray(ap1.array_coefficients), zero1], axis=0)
        if ap1.array_coefficients is not None
        else zero1
    )
    coeffs2 = (
        xp.concatenate([xp.asarray(ap2.array_coefficients), zero2], axis=0)
        if ap2.array_coefficients is not None
        else zero2
    )
    new_coeffs = coeffs1[idx1] + coeffs2[idx2]
    return ArrayPolynomial(
        constant_term=const, array_coefficients=new_coeffs, monomial_labels=labels
    )


def _poly_distributive_op(
    ap1: ArrayPolynomial,
    ap2: ArrayPolynomial,
    binary_op: Callable,
    monomial_filter: Optional[Callable],
) -> ArrayPolynomial:
    """Distribute ``binary_op`` over all term pairs, with label filtering.

    Output label for a pair ``(I, J)`` is the multiset sum ``I + J``. The
    sparse rule over (constant + coefficient) stacks is compiled host-side and
    executed via :mod:`.custom_dot`."""
    if monomial_filter is None:
        monomial_filter = lambda _: True

    labels = set()
    if ap1.constant_term is not None:
        labels.update(m for m in ap2.monomial_labels if monomial_filter(m))
    if ap2.constant_term is not None:
        labels.update(m for m in ap1.monomial_labels if monomial_filter(m))
    for I, J in _iter_product(ap1.monomial_labels, ap2.monomial_labels):
        IuJ = tuple(sorted(I + J))
        if monomial_filter(IuJ):
            labels.add(IuJ)
    labels = sorted_multisets(labels)

    const = None
    if ap1.constant_term is not None and ap2.constant_term is not None and monomial_filter(()):
        const = binary_op(ap1.constant_term, ap2.constant_term)

    if not labels:
        return ArrayPolynomial(constant_term=const)

    # rule over stacked [constant, *coefficients]; constant encoded as -1
    rule = []
    for ms in labels:
        pairs = []
        if ms in ap1.monomial_labels:
            pairs.append([ap1.monomial_labels.index(ms), -1])
        if ms in ap2.monomial_labels:
            pairs.append([-1, ap2.monomial_labels.index(ms)])
        if len(ms) > 1:
            for I, J in zip(*submultisets_and_complements(ms)):
                if I in ap1.monomial_labels and J in ap2.monomial_labels:
                    pair = [ap1.monomial_labels.index(I), ap2.monomial_labels.index(J)]
                    if pair not in pairs:
                        pairs.append(pair)
        if pairs:
            rule.append((np.ones(len(pairs)), np.array(pairs, dtype=int)))

    use_jax = isinstance(ap1.array_coefficients, jax.Array) or isinstance(
        ap2.array_coefficients, jax.Array
    )
    xp = jnp if use_jax else np

    def stacked(ap):
        if ap.constant_term is not None:
            head = xp.expand_dims(xp.asarray(ap.constant_term), 0)
        else:
            head = xp.zeros((1,) + ap.shape, dtype=complex)
        if ap.array_coefficients is not None:
            return xp.concatenate([head, xp.asarray(ap.array_coefficients)], axis=0)
        return head

    op = _CustomBinaryOp(rule, binary_op, index_offset=1)
    new_coeffs = op(stacked(ap1), stacked(ap2))
    return ArrayPolynomial(
        constant_term=const, array_coefficients=new_coeffs, monomial_labels=labels
    )
