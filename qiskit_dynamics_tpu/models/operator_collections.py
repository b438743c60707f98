"""Operator collections: the RHS math kernels.

TPU-first re-design of
``/root/reference/qiskit_dynamics/models/operator_collections.py``. Dense JAX
is the primary path; ``jax_sparse`` (BCOO) and host-side ``scipy_sparse``
variants cover large sparse Hilbert spaces.

The Lindblad RHS is expressed as ``(A+B) y + y (A-B) + C`` with
``A = -1/2 Sigma_j gamma_j L_j^dag L_j`` (products precomputed at
construction), ``B = -iH``, ``C = Sigma_j gamma_j L_j y L_j^dag``
(reference math at ``operator_collections.py:451-567``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..unified import unp, contains_tracer
from jax.experimental import sparse as jsparse
from jax.tree_util import register_pytree_node
from scipy.sparse import csr_matrix, issparse

from ..exceptions import DynamicsError
from ..ops.linear_combo import linear_combo, linear_combo_bcoo
from .model_utils import vec_commutator, vec_dissipator

__all__ = [
    "OperatorCollection",
    "ScipySparseOperatorCollection",
    "LindbladCollection",
    "ScipySparseLindbladCollection",
    "VectorizedLindbladCollection",
    "ScipySparseVectorizedLindbladCollection",
]


def _asarray_or_none(x):
    return None if x is None else unp.asarray(x)


class OperatorCollection:
    r"""Evaluates ``Lambda(c, y) = (G_d + Sigma_j c_j G_j) y``.

    ``operators`` is a ``(k, n, n)`` stack; ``static_operator`` is ``(n, n)``.
    Dense by default; pass BCOO arrays for the jax-sparse path.
    """

    def __init__(self, static_operator=None, operators=None, array_library=None):
        if array_library == "scipy_sparse":
            raise DynamicsError(
                "scipy_sparse is not a valid array_library for OperatorCollection."
            )
        self._sparse = array_library == "jax_sparse"
        if self._sparse:
            self._static_operator = (
                None
                if static_operator is None
                else jsparse.BCOO.fromdense(jnp.asarray(static_operator))
            )
            self._operators = (
                None
                if operators is None
                else jsparse.BCOO.fromdense(jnp.asarray(operators), n_batch=1)
            )
        else:
            self._static_operator = _asarray_or_none(static_operator)
            self._operators = _asarray_or_none(operators)

    @property
    def dim(self) -> int:
        """Matrix dimension."""
        if self._static_operator is not None:
            return self._static_operator.shape[-1]
        return self._operators.shape[-1]

    @property
    def static_operator(self):
        """The static operator ``G_d``."""
        return self._static_operator

    @property
    def operators(self):
        """The operator stack ``G_j``."""
        return self._operators

    def evaluate(self, coefficients):
        r"""Return ``G_d + Sigma_j c_j G_j``."""
        if self._operators is not None:
            if self._sparse:
                combo = linear_combo_bcoo(coefficients, self._operators)
            else:
                combo = linear_combo(coefficients, self._operators)
            if self._static_operator is not None:
                return combo + self._static_operator
            return combo
        if self._static_operator is not None:
            return self._static_operator
        raise DynamicsError(
            "OperatorCollection with None for both static_operator and operators "
            "cannot be evaluated."
        )

    def evaluate_rhs(self, coefficients, y):
        r"""Return ``(G_d + Sigma_j c_j G_j) y``.

        For 1d ``y`` the operators are multiplied into the state BEFORE the
        linear combination (``Sigma_j c_j (G_j y)``), like the reference's
        sparse path (``operator_collections.py:238-248``) — but here for the
        batched layout: under ``vmap`` over a parameter sweep this shape
        becomes one ``(k*n, n) @ (n, B)`` matmul with the sweep batch as the
        wide dimension, instead of B independent small ``(n, n)`` matmuls.
        """
        if not self._sparse and jnp.ndim(y) == 1 and self._operators is not None:
            xp = jnp if (contains_tracer(coefficients, y)
                         or isinstance(y, jax.Array)
                         or isinstance(coefficients, jax.Array)) else np
            op_dot_y = xp.tensordot(self._operators, y, axes=(2, 0))  # (k, n)
            rhs = xp.tensordot(coefficients, op_dot_y, axes=(0, 0))
            if self._static_operator is not None:
                rhs = rhs + self._static_operator @ y
            return rhs
        gen = self.evaluate(coefficients)
        if self._sparse:
            return jsparse.bcoo_dot_general(
                gen, jnp.asarray(y), dimension_numbers=(((1,), (0,)), ((), ()))
            )
        return gen @ y

    def __call__(self, coefficients, y=None):
        if y is None:
            return self.evaluate(coefficients)
        return self.evaluate_rhs(coefficients, y)

    # --- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        return (self._static_operator, self._operators), (self._sparse,)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        (obj._sparse,) = aux
        obj._static_operator, obj._operators = leaves
        return obj


class ScipySparseOperatorCollection:
    r"""Host-side CSR version of :class:`OperatorCollection` for scipy solvers.

    Operator entries are rounded to ``decimals`` to sparsify near-zero noise
    (reference ``operator_collections.py:167-174``).
    """

    def __init__(self, static_operator=None, operators=None, decimals: int = 10):
        self._static_operator = (
            None
            if static_operator is None
            else csr_matrix(np.round(np.asarray(static_operator), decimals))
        )
        self._operators = (
            None
            if operators is None
            else [csr_matrix(np.round(np.asarray(op), decimals)) for op in operators]
        )

    @property
    def dim(self) -> int:
        """Hilbert-space dimension."""
        if self._static_operator is not None:
            return self._static_operator.shape[-1]
        return self._operators[0].shape[-1]

    @property
    def static_operator(self):
        """The static operator."""
        return self._static_operator

    @property
    def operators(self):
        """List of CSR operators."""
        return self._operators

    def evaluate(self, coefficients):
        r"""Return ``G_d + Sigma_j c_j G_j`` as a CSR matrix."""
        if self._operators is not None:
            coefficients = np.asarray(coefficients)
            combo = sum(c * op for c, op in zip(coefficients, self._operators))
            if self._static_operator is not None:
                combo = combo + self._static_operator
            return combo
        if self._static_operator is not None:
            return self._static_operator
        raise DynamicsError(
            "ScipySparseOperatorCollection with None for both static_operator and "
            "operators cannot be evaluated."
        )

    def evaluate_rhs(self, coefficients, y):
        r"""Return ``(G_d + Sigma_j c_j G_j) y``.

        For 1-d ``y``, each operator is applied to ``y`` before the linear
        combination — sparse matvecs beat materializing the generator
        (reference ``operator_collections.py:238-248``).
        """
        y = np.asarray(y)
        if y.ndim == 1 and self._operators is not None:
            coefficients = np.asarray(coefficients)
            out = 0.0
            if self._static_operator is not None:
                out = self._static_operator @ y
            applied = np.array([op @ y for op in self._operators])
            out = out + coefficients @ applied
            return out
        gen = self.evaluate(coefficients)
        return np.asarray(gen @ y)

    def __call__(self, coefficients, y=None):
        if y is None:
            return self.evaluate(coefficients)
        return self.evaluate_rhs(coefficients, y)


class LindbladCollection:
    r"""Two-coefficient-set Lindblad RHS evaluator (dense JAX / BCOO).

    Evaluates ``-i[H, y] + Sigma_j gamma_j (L_j y L_j^dag - 1/2 {L_j^dag L_j, y})``
    with optional static Hamiltonian/dissipators, via ``(A+B)y + y(A-B) + C``.
    """

    def __init__(
        self,
        static_hamiltonian=None,
        hamiltonian_operators=None,
        static_dissipators=None,
        dissipator_operators=None,
        array_library: Optional[str] = None,
    ):
        if array_library == "scipy_sparse":
            raise DynamicsError(
                "scipy_sparse is not a valid array_library for LindbladCollection."
            )
        # NOTE: the jax_sparse path stores the Hamiltonian terms as BCOO; the
        # dissipator triple products stay dense (they densify under conjugation).
        self._sparse = array_library == "jax_sparse"

        if self._sparse:
            self._static_hamiltonian = (
                None
                if static_hamiltonian is None
                else jsparse.BCOO.fromdense(jnp.asarray(static_hamiltonian))
            )
            self._hamiltonian_operators = (
                None
                if hamiltonian_operators is None
                else jsparse.BCOO.fromdense(jnp.asarray(hamiltonian_operators), n_batch=1)
            )
        else:
            self._static_hamiltonian = _asarray_or_none(static_hamiltonian)
            self._hamiltonian_operators = _asarray_or_none(hamiltonian_operators)

        if static_dissipators is not None:
            sd = unp.asarray(static_dissipators)
            self._static_dissipators = sd
            self._static_dissipators_adj = unp.conjugate(unp.transpose(sd, (0, 2, 1)))
            self._static_dissipators_product_sum = -0.5 * unp.sum(
                self._static_dissipators_adj @ sd, axis=0
            )
        else:
            self._static_dissipators = None
            self._static_dissipators_adj = None
            self._static_dissipators_product_sum = None

        if dissipator_operators is not None:
            do = unp.asarray(dissipator_operators)
            self._dissipator_operators = do
            self._dissipator_operators_adj = unp.conjugate(unp.transpose(do, (0, 2, 1)))
            self._dissipator_products = -0.5 * (self._dissipator_operators_adj @ do)
        else:
            self._dissipator_operators = None
            self._dissipator_operators_adj = None
            self._dissipator_products = None

    @property
    def static_hamiltonian(self):
        """Static Hamiltonian term."""
        return self._static_hamiltonian

    @property
    def hamiltonian_operators(self):
        """Hamiltonian operator stack."""
        return self._hamiltonian_operators

    @property
    def static_dissipators(self):
        """Static dissipator stack."""
        return self._static_dissipators

    @property
    def dissipator_operators(self):
        """Dissipator operator stack."""
        return self._dissipator_operators

    def evaluate_hamiltonian(self, ham_coefficients):
        r"""Return ``H_d + Sigma_j s_j H_j``."""
        if self._hamiltonian_operators is not None:
            if self._sparse:
                combo = linear_combo_bcoo(ham_coefficients, self._hamiltonian_operators)
            else:
                combo = linear_combo(ham_coefficients, self._hamiltonian_operators)
            if self._static_hamiltonian is not None:
                return combo + self._static_hamiltonian
            return combo
        if self._static_hamiltonian is not None:
            return self._static_hamiltonian
        raise DynamicsError(
            f"{type(self).__name__} with None for both static_hamiltonian and "
            "hamiltonian_operators cannot evaluate Hamiltonian."
        )

    def evaluate(self, ham_coefficients, dis_coefficients):
        """Non-vectorized Lindblad maps cannot be evaluated as matrices."""
        raise ValueError(
            "Non-vectorized Lindblad collections cannot be evaluated without a state."
        )

    def evaluate_rhs(self, ham_coefficients, dis_coefficients, y):
        r"""Lindblad RHS on ``(n, n)`` or batched ``(B, n, n)`` density matrices."""
        y = unp.asarray(y)

        ham_matrix = None
        if self._static_hamiltonian is not None or self._hamiltonian_operators is not None:
            ham = self.evaluate_hamiltonian(ham_coefficients)
            if self._sparse and isinstance(ham, jsparse.BCOO):
                ham = ham.todense()
            ham_matrix = -1j * ham  # B

        if self._dissipator_operators is None and self._static_dissipators is None:
            if ham_matrix is None:
                raise DynamicsError(
                    "LindbladCollection with no Hamiltonian or dissipator terms cannot "
                    "evaluate rhs."
                )
            return ham_matrix @ y - y @ ham_matrix

        # A matrix
        if self._static_dissipators is None:
            diss_matrix = linear_combo(dis_coefficients, self._dissipator_products)
        elif self._dissipator_operators is None:
            diss_matrix = self._static_dissipators_product_sum
        else:
            diss_matrix = self._static_dissipators_product_sum + linear_combo(
                dis_coefficients, self._dissipator_products
            )

        if ham_matrix is not None:
            left = (ham_matrix + diss_matrix) @ y
            right = y @ (diss_matrix - ham_matrix)
        else:
            left = diss_matrix @ y
            right = y @ diss_matrix

        # C: Sigma_j gamma_j L_j y L_j^dag; broadcast batched y over the
        # dissipator axis
        yb = y[..., None, :, :] if y.ndim == 3 else y
        if self._dissipator_operators is not None:
            mats = self._dissipator_operators @ (yb @ self._dissipator_operators_adj)
            dis_coefficients = unp.asarray(dis_coefficients)
            both = unp.tensordot(dis_coefficients, mats.real, axes=[[-1], [-3]]) + 1j * (
                unp.tensordot(dis_coefficients, mats.imag, axes=[[-1], [-3]])
            )
            if self._static_dissipators is not None:
                both = both + unp.sum(
                    self._static_dissipators @ (yb @ self._static_dissipators_adj), axis=-3
                )
        else:
            both = unp.sum(
                self._static_dissipators @ (yb @ self._static_dissipators_adj), axis=-3
            )

        return left + right + both

    def __call__(self, ham_coefficients, dis_coefficients, y=None):
        if y is None:
            return self.evaluate(ham_coefficients, dis_coefficients)
        return self.evaluate_rhs(ham_coefficients, dis_coefficients, y)

    # --- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        leaves = (
            self._static_hamiltonian,
            self._hamiltonian_operators,
            self._static_dissipators,
            self._static_dissipators_adj,
            self._static_dissipators_product_sum,
            self._dissipator_operators,
            self._dissipator_operators_adj,
            self._dissipator_products,
        )
        return leaves, (self._sparse,)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        (obj._sparse,) = aux
        (
            obj._static_hamiltonian,
            obj._hamiltonian_operators,
            obj._static_dissipators,
            obj._static_dissipators_adj,
            obj._static_dissipators_product_sum,
            obj._dissipator_operators,
            obj._dissipator_operators_adj,
            obj._dissipator_products,
        ) = leaves
        return obj


class ScipySparseLindbladCollection:
    """Host-side CSR Lindblad RHS for scipy solvers."""

    def __init__(
        self,
        static_hamiltonian=None,
        hamiltonian_operators=None,
        static_dissipators=None,
        dissipator_operators=None,
        decimals: int = 10,
    ):
        def to_csr(x):
            return csr_matrix(np.round(np.asarray(x), decimals))

        self._static_hamiltonian = (
            None if static_hamiltonian is None else to_csr(static_hamiltonian)
        )
        self._hamiltonian_operators = (
            None
            if hamiltonian_operators is None
            else [to_csr(op) for op in hamiltonian_operators]
        )
        if static_dissipators is not None:
            self._static_dissipators = [to_csr(op) for op in static_dissipators]
            self._static_dissipators_adj = [op.conj().T.tocsr() for op in self._static_dissipators]
            self._static_dissipators_product_sum = -0.5 * sum(
                adj @ op
                for adj, op in zip(self._static_dissipators_adj, self._static_dissipators)
            )
        else:
            self._static_dissipators = None
        if dissipator_operators is not None:
            self._dissipator_operators = [to_csr(op) for op in dissipator_operators]
            self._dissipator_operators_adj = [
                op.conj().T.tocsr() for op in self._dissipator_operators
            ]
            self._dissipator_products = [
                -0.5 * (adj @ op)
                for adj, op in zip(self._dissipator_operators_adj, self._dissipator_operators)
            ]
        else:
            self._dissipator_operators = None

    @property
    def static_hamiltonian(self):
        """Static Hamiltonian term."""
        return self._static_hamiltonian

    @property
    def hamiltonian_operators(self):
        """Hamiltonian operator list."""
        return self._hamiltonian_operators

    @property
    def static_dissipators(self):
        """Static dissipator list."""
        return self._static_dissipators

    @property
    def dissipator_operators(self):
        """Dissipator operator list."""
        return self._dissipator_operators

    def evaluate_hamiltonian(self, ham_coefficients):
        r"""Return ``H_d + Sigma_j s_j H_j`` as CSR."""
        if self._hamiltonian_operators is not None:
            combo = sum(
                c * op for c, op in zip(np.asarray(ham_coefficients), self._hamiltonian_operators)
            )
            if self._static_hamiltonian is not None:
                combo = combo + self._static_hamiltonian
            return combo
        if self._static_hamiltonian is not None:
            return self._static_hamiltonian
        raise DynamicsError(
            f"{type(self).__name__} with None for both static_hamiltonian and "
            "hamiltonian_operators cannot evaluate Hamiltonian."
        )

    def evaluate(self, ham_coefficients, dis_coefficients):
        """Non-vectorized Lindblad maps cannot be evaluated as matrices."""
        raise ValueError(
            "Non-vectorized Lindblad collections cannot be evaluated without a state."
        )

    def evaluate_rhs(self, ham_coefficients, dis_coefficients, y):
        """Lindblad RHS on one or a batch of dense density matrices."""
        y = np.asarray(y)
        batched = y.ndim == 3
        ys = y if batched else y[None]

        ham_matrix = None
        if self._static_hamiltonian is not None or self._hamiltonian_operators is not None:
            ham_matrix = -1j * self.evaluate_hamiltonian(ham_coefficients)

        out = np.zeros_like(ys, dtype=complex)
        for i, rho in enumerate(ys):
            if self._dissipator_operators is None and self._static_dissipators is None:
                out[i] = ham_matrix @ rho - rho @ ham_matrix
                continue
            A = 0.0
            if self._static_dissipators is not None:
                A = A + self._static_dissipators_product_sum
            if self._dissipator_operators is not None:
                gammas = np.asarray(dis_coefficients)
                A = A + sum(g * p for g, p in zip(gammas, self._dissipator_products))
            if ham_matrix is not None:
                left = (ham_matrix + A) @ rho
                right = rho @ (A - ham_matrix)
            else:
                left = A @ rho
                right = rho @ A
            C = np.zeros_like(rho)
            if self._static_dissipators is not None:
                for L, Ld in zip(self._static_dissipators, self._static_dissipators_adj):
                    C = C + L @ rho @ Ld
            if self._dissipator_operators is not None:
                for g, L, Ld in zip(
                    np.asarray(dis_coefficients),
                    self._dissipator_operators,
                    self._dissipator_operators_adj,
                ):
                    C = C + g * (L @ rho @ Ld)
            out[i] = left + right + C
        return out if batched else out[0]

    def __call__(self, ham_coefficients, dis_coefficients, y=None):
        if y is None:
            return self.evaluate(ham_coefficients, dis_coefficients)
        return self.evaluate_rhs(ham_coefficients, dis_coefficients, y)


class VectorizedLindbladCollection:
    r"""Column-stacking vectorized Lindblad collection.

    Precomputes ``(n^2, n^2)`` superoperators via :func:`vec_commutator` /
    :func:`vec_dissipator` and delegates to an internal
    :class:`OperatorCollection` over the concatenated
    ``[hamiltonian, dissipator]`` coefficient vector (reference
    ``operator_collections.py:851-1061``).
    """

    _collection_cls = OperatorCollection

    def __init__(
        self,
        static_hamiltonian=None,
        hamiltonian_operators=None,
        static_dissipators=None,
        dissipator_operators=None,
        array_library: Optional[str] = None,
    ):
        self._array_library = array_library
        if array_library == "scipy_sparse" and self._collection_cls is OperatorCollection:
            raise DynamicsError(
                "scipy_sparse is not a valid array_library for VectorizedLindbladCollection."
            )

        self._static_hamiltonian = _asarray_or_none(static_hamiltonian)
        self._hamiltonian_operators = _asarray_or_none(hamiltonian_operators)
        self._static_dissipators = _asarray_or_none(static_dissipators)
        self._dissipator_operators = _asarray_or_none(dissipator_operators)

        static_operator = None
        if self._static_hamiltonian is not None:
            static_operator = vec_commutator(self._static_hamiltonian)
        if self._static_dissipators is not None:
            sd = unp.sum(vec_dissipator(self._static_dissipators), axis=0)
            static_operator = sd if static_operator is None else static_operator + sd

        op_list = []
        if self._hamiltonian_operators is not None:
            op_list.append(vec_commutator(self._hamiltonian_operators))
        if self._dissipator_operators is not None:
            op_list.append(vec_dissipator(self._dissipator_operators))
        operators = unp.concatenate(op_list, axis=0) if op_list else None

        self._operator_collection = self._construct_operator_collection(
            static_operator=static_operator, operators=operators
        )

    def _construct_operator_collection(self, static_operator, operators):
        return self._collection_cls(
            static_operator=static_operator,
            operators=operators,
            array_library=self._array_library,
        )

    @property
    def static_hamiltonian(self):
        """Static Hamiltonian term."""
        return self._static_hamiltonian

    @property
    def hamiltonian_operators(self):
        """Hamiltonian operator stack."""
        return self._hamiltonian_operators

    @property
    def static_dissipators(self):
        """Static dissipator stack."""
        return self._static_dissipators

    @property
    def dissipator_operators(self):
        """Dissipator operator stack."""
        return self._dissipator_operators

    def evaluate_hamiltonian(self, ham_coefficients):
        r"""Return ``H_d + Sigma_j s_j H_j`` (unvectorized)."""
        if self._hamiltonian_operators is not None:
            combo = linear_combo(ham_coefficients, self._hamiltonian_operators)
            if self._static_hamiltonian is not None:
                return combo + self._static_hamiltonian
            return combo
        if self._static_hamiltonian is not None:
            return self._static_hamiltonian
        raise DynamicsError(
            f"{type(self).__name__} with None for both static_hamiltonian and "
            "hamiltonian_operators cannot evaluate Hamiltonian."
        )

    def _concatenate_coefficients(self, ham_coefficients, dis_coefficients):
        if self._hamiltonian_operators is not None and self._dissipator_operators is not None:
            return unp.concatenate(
                [unp.atleast_1d(unp.asarray(ham_coefficients)),
                 unp.atleast_1d(unp.asarray(dis_coefficients))],
                axis=-1,
            )
        if self._hamiltonian_operators is not None:
            return ham_coefficients
        if self._dissipator_operators is not None:
            return dis_coefficients
        return None

    def evaluate(self, ham_coefficients, dis_coefficients):
        """Return the ``(n^2, n^2)`` vectorized generator."""
        coeffs = self._concatenate_coefficients(ham_coefficients, dis_coefficients)
        return self._operator_collection.evaluate(coeffs)

    def evaluate_rhs(self, ham_coefficients, dis_coefficients, y):
        """Apply the vectorized generator to a column-stacked state."""
        coeffs = self._concatenate_coefficients(ham_coefficients, dis_coefficients)
        return self._operator_collection.evaluate_rhs(coeffs, y)

    def __call__(self, ham_coefficients, dis_coefficients, y=None):
        if y is None:
            return self.evaluate(ham_coefficients, dis_coefficients)
        return self.evaluate_rhs(ham_coefficients, dis_coefficients, y)


class _ScipySparseOperatorCollectionAdapter(ScipySparseOperatorCollection):
    """Adapter accepting the dense-style constructor signature."""

    def __init__(self, static_operator=None, operators=None, array_library=None):
        operators_list = None if operators is None else list(np.asarray(operators))
        super().__init__(static_operator=static_operator, operators=operators_list)


class ScipySparseVectorizedLindbladCollection(VectorizedLindbladCollection):
    """Host-side CSR variant of :class:`VectorizedLindbladCollection`."""

    _collection_cls = _ScipySparseOperatorCollectionAdapter

    def __init__(
        self,
        static_hamiltonian=None,
        hamiltonian_operators=None,
        static_dissipators=None,
        dissipator_operators=None,
        **kwargs,
    ):
        super().__init__(
            static_hamiltonian=static_hamiltonian,
            hamiltonian_operators=hamiltonian_operators,
            static_dissipators=static_dissipators,
            dissipator_operators=dissipator_operators,
            array_library="scipy_sparse",
        )


register_pytree_node(
    OperatorCollection, OperatorCollection.tree_flatten, OperatorCollection.tree_unflatten
)
register_pytree_node(
    LindbladCollection, LindbladCollection.tree_flatten, LindbladCollection.tree_unflatten
)
