"""Compiled sparse linear-combination binary ops (host-compiled, device-executed).

Implements the ``(A x B)_i = sum_jk a_ijk f(A_j, B_k)`` primitive underlying
the Dyson/Magnus term recursions (reference behavior:
``/root/reference/qiskit_dynamics/perturbation/custom_binary_op.py``).

The sparse rule — a list of ``(coeffs, index_pairs)`` per output entry — is
compiled **on the host** into dense padded tables:

- ``pairs``: (E, 2) int array of unique ``(j, k)`` evaluation pairs
  (padded with ``(-1, -1)``);
- ``coeffs``/``idx``: (I, L) linear-combination tables (padded with 0 / -1).

Device execution is then branch-free: one batched gather,
one ``vmap``-ed binary op over the unique pairs, and one einsum contraction —
no per-entry Python, no data-dependent control flow.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..unified import contains_tracer

__all__ = ["CompiledRule", "compile_rule", "CustomMatmul", "CustomMul"]


class CompiledRule:
    """Container for a compiled rule: ``(pairs, (coeffs, idx))``."""

    __slots__ = ("pairs", "coeffs", "idx")

    def __init__(self, pairs: np.ndarray, coeffs: np.ndarray, idx: np.ndarray):
        self.pairs = pairs
        self.coeffs = coeffs
        self.idx = idx

    def astuple(self):
        return self.pairs, (self.coeffs, self.idx)


def compile_rule(
    operation_rule: List[Tuple[np.ndarray, np.ndarray]],
    index_offset: int = 0,
    unique_evaluation_len: Optional[int] = None,
    linear_combo_len: Optional[int] = None,
) -> CompiledRule:
    """Compile a sparse rule into padded unique-pair + linear-combo tables.

    Args:
        operation_rule: list over output entries; each entry is
            ``(coeffs, index_pairs)`` with ``index_pairs`` of shape (m, 2).
        index_offset: shift added to all indices (used to encode "generator at
            -1" conventions).
        unique_evaluation_len: minimum row count for the pair table (padded
            with ``(-1, -1)``) — used to stack rules of different sizes.
        linear_combo_len: minimum column count for the combo tables.
    """
    unique_pairs: List[Tuple[int, int]] = []
    pair_index: dict = {}
    combo_rows: List[Tuple[np.ndarray, List[int]]] = []
    for coeffs, index_pairs in operation_rule:
        coeffs = np.asarray(coeffs)
        index_pairs = np.asarray(index_pairs, dtype=int) + index_offset
        row_idx: List[int] = []
        for pair in index_pairs:
            key = (int(pair[0]), int(pair[1]))
            if key not in pair_index:
                pair_index[key] = len(unique_pairs)
                unique_pairs.append(key)
            row_idx.append(pair_index[key])
        combo_rows.append((coeffs, row_idx))

    pairs = np.asarray(unique_pairs, dtype=int).reshape(-1, 2)
    if unique_evaluation_len is not None and unique_evaluation_len > len(pairs):
        pad = -np.ones((unique_evaluation_len - len(pairs), 2), dtype=int)
        pairs = np.concatenate([pairs, pad], axis=0)

    max_len = max([linear_combo_len or 0] + [len(c) for c, _ in combo_rows])
    coeff_table = np.zeros((len(combo_rows), max_len), dtype=complex)
    idx_table = -np.ones((len(combo_rows), max_len), dtype=int)
    for i, (coeffs, row_idx) in enumerate(combo_rows):
        coeff_table[i, : len(coeffs)] = coeffs
        idx_table[i, : len(row_idx)] = row_idx

    return CompiledRule(pairs, coeff_table, idx_table)


def _apply_jax(A, B, rule: CompiledRule, binary_op: Callable):
    # zero row appended so padded (-1, -1) pairs evaluate to zero
    A = jnp.concatenate([A, jnp.zeros((1,) + A.shape[1:], dtype=A.dtype)], axis=0)
    B = jnp.concatenate([B, jnp.zeros((1,) + B.shape[1:], dtype=B.dtype)], axis=0)
    uniq = jax.vmap(binary_op)(A[rule.pairs[:, 0]], B[rule.pairs[:, 1]])
    # out[i] = sum_l coeffs[i, l] * uniq[idx[i, l]]; padded coeffs are 0
    gathered = uniq[rule.idx]  # (I, L, ...)
    coeffs = jnp.asarray(rule.coeffs, dtype=gathered.dtype)
    return jnp.einsum("il,il...->i...", coeffs, gathered)


def _apply_numpy(A, B, rule: CompiledRule, binary_op: Callable):
    A = np.asarray(A)
    B = np.asarray(B)
    first = None
    uniq = None
    for e, (j, k) in enumerate(rule.pairs):
        if j == -1:
            continue
        val = binary_op(A[j], B[k])
        if uniq is None:
            first = val
            uniq = np.zeros((len(rule.pairs),) + first.shape, dtype=complex)
        uniq[e] = val
    out = np.zeros((len(rule.coeffs),) + uniq.shape[1:], dtype=complex)
    for i in range(len(rule.coeffs)):
        for c, e in zip(rule.coeffs[i], rule.idx[i]):
            if e != -1 and c != 0:
                out[i] = out[i] + c * uniq[e]
    return out


class _CustomBinaryOp:
    """Custom binary op from a (possibly pre-compiled) sparse rule."""

    def __init__(self, operation_rule, binary_op: Callable, index_offset: int = 0):
        self._binary_op = binary_op
        if isinstance(operation_rule, CompiledRule):
            self._rule = operation_rule
        elif (
            isinstance(operation_rule, tuple)
            and len(operation_rule) == 2
            and isinstance(operation_rule[1], tuple)
        ):
            # pass through untouched: the tables may be jax tracers (e.g. when
            # stacked rules are scanned over on device)
            pairs, (coeffs, idx) = operation_rule
            self._rule = CompiledRule(pairs, coeffs, idx)
        else:
            self._rule = compile_rule(operation_rule, index_offset)

    @property
    def compiled_rule(self) -> CompiledRule:
        return self._rule

    def __call__(self, A, B):
        if contains_tracer(A, B) or isinstance(A, jax.Array) or isinstance(B, jax.Array):
            return _apply_jax(jnp.asarray(A), jnp.asarray(B), self._rule, self._binary_op)
        return _apply_numpy(A, B, self._rule, self._binary_op)


class CustomMatmul(_CustomBinaryOp):
    """Compiled linear combination of matrix products."""

    def __init__(self, operation_rule, index_offset: int = 0):
        super().__init__(operation_rule, lambda a, b: a @ b, index_offset)


class CustomMul(_CustomBinaryOp):
    """Compiled linear combination of elementwise products."""

    def __init__(self, operation_rule, index_offset: int = 0):
        super().__init__(operation_rule, lambda a, b: a * b, index_offset)
