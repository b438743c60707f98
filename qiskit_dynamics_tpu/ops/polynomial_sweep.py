r"""Polynomial-expanded Magnus sweep engine: the large-dim fast path.

The batch-major XLA engine (:mod:`.xla_sweep`) spends its time, at large
``n``, in per-member batched commutator matmuls: Magnus order 3 with
non-anti-Hermitian generators costs 6 ``(B, n, n) @ (B, n, n)`` products per
step, ~8e8 real flops per member per step at ``n = 256``.

This engine removes the batched matmuls ALGEBRAICALLY. The frame phase mask
is a diagonal conjugation — ``P(t) ∘ A = D(t) A D(t)^{-1}`` with
``D = diag(exp(d t))`` (the repo-wide rank-1 frame structure,
``models/rotating_frame.py``) — so every Gauss-point generator is

.. math:: G_i = D_r\,\tilde A_i\,D_r^{-1},\qquad
          \tilde A_i = E_i\Big(S + \sum_k c_{ik} O_k\Big)E_i^{-1},

with ``D_r = D(t_{ref})`` shared by all Gauss points of the step and
``E_i = D(tau_i - t_ref)`` a CONSTANT diagonal (the Gauss offsets are fixed
fractions of ``dt``). Conjugation by ``D_r`` is a ring homomorphism, so the
whole Magnus bracket polynomial evaluates on the ``tilde A_i`` and the
``D_r`` sandwich moves to the very end — where it cancels into the state
transform: ``expm(D M D^{-1}) y = D\,expm(M)\,D^{-1} y``. The bracket
polynomial itself is MULTILINEAR in the per-member Gauss coefficients, so it
expands (once, host-side, float64 — all commutator cancellations happen
there) into

.. math:: \tilde M_b = \sum_q \mathrm{mono}_q(c_b)\, X_q

with ``Q`` member-independent matrices ``X_q`` (Q <= 56 for one drive
operator at Magnus order 3). Per step the device then does: one monomial
gather-product ``(Q, B)``, ONE ``(B, Q) @ (Q, n^2)`` matmul, two
diagonal phase multiplies on the state, and the Horner ``expm`` action — no
batched ``n^3`` work at all. Same step rule, same polynomial, ~10x fewer
flops at dim 256.

Reference math: Magnus Gauss-point rules
(``/root/reference/qiskit_dynamics/solvers/fixed_step_solvers.py:321-403``);
the expansion trick has no reference counterpart.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .xla_sweep import (
    _GAUSS3_D1,
    _GAUSS3_D2,
    _GAUSS3_D3,
    _GAUSS_C1,
    _GAUSS_C2,
    _M3_C0,
    _M3_C1,
    _P2,
    _validate_eval_slots,
)
from .trig_reduce import reduced_phase, split_const, step_time_df

__all__ = ["sweep_expm_magnus_poly", "expand_magnus_polynomial"]


# ---------------------------------------------------------------------------
# host-side symbolic expansion: dict{monomial tuple -> (n, n) complex128}


def _padd(p, q, scale=1.0):
    out = dict(p)
    for m, X in q.items():
        out[m] = out.get(m, 0.0) + scale * X
    return out


def _pscale(p, scale):
    return {m: scale * X for m, X in p.items()}


def _pprod(p, q):
    out = {}
    for m1, X1 in p.items():
        for m2, X2 in q.items():
            m = tuple(sorted(m1 + m2))
            prod = X1 @ X2
            if m in out:
                out[m] = out[m] + prod
            else:
                out[m] = prod
    return out


def _pcomm(p, q):
    return _padd(_pprod(p, q), _pprod(q, p), scale=-1.0)


def expand_magnus_polynomial(
    static_op, operators, frame_diag, dt: float, magnus_order: int
):
    """Expand the Magnus step matrix as a monomial polynomial of the Gauss
    coefficients (host, float64 — see the module docstring).

    Variables are flat indices ``i * k + j`` for Gauss point ``i`` and
    operator ``j``. Returns ``(mon_index, X)``: a ``(Q, deg_max)`` int32
    gather matrix (sentinel = n_vars, gathers an appended ones-row) and the
    stacked ``(Q, n, n)`` complex128 coefficient matrices of
    ``M_tilde = sum_q prod(c[mon_index[q]]) X_q`` (reference frame
    ``t_ref = step midpoint``).
    """
    if magnus_order not in (2, 3):
        raise ValueError(f"magnus_order must be 2 or 3, got {magnus_order!r}")
    S = np.asarray(static_op, dtype=np.complex128)
    ops = np.asarray(operators, dtype=np.complex128)
    d = np.asarray(frame_diag, dtype=np.complex128)
    n = S.shape[0]
    k = ops.shape[0]
    nodes = (
        (_GAUSS_C1, _GAUSS_C2) if magnus_order == 2 else (_GAUSS3_D1, _GAUSS3_D2, _GAUSS3_D3)
    )
    t_ref = 0.5

    # tilde A_i = E_i (S + sum_k c_ik O_k) E_i^{-1}, E_i = diag(exp(d (tau_i - t_ref) dt))
    a_tilde = []
    for i, c in enumerate(nodes):
        E = np.exp(d * ((c - t_ref) * dt))
        Einv = np.exp(-d * ((c - t_ref) * dt))
        sand = lambda A, E=E, Einv=Einv: (E[:, None] * A) * Einv[None, :]
        poly = {(): sand(S)}
        for j in range(k):
            poly[(i * k + j,)] = sand(ops[j])
        a_tilde.append(poly)

    if magnus_order == 2:
        A1, A2 = a_tilde
        M = _padd(_pscale(_padd(A1, A2), 0.5 * dt), _pcomm(A2, A1), scale=_P2 * dt * dt)
    else:
        A1, A2, A3 = a_tilde
        a1 = _pscale(A2, dt)
        a2 = _pscale(_padd(A3, A1, scale=-1.0), _M3_C0 * dt)
        a3 = _pscale(
            _padd(_padd(A3, A2, scale=-2.0), A1), _M3_C1 * dt
        )
        C1 = _pcomm(a1, a2)
        C2 = _pscale(_pcomm(_padd(_pscale(a3, 2.0), C1), a1), 1.0 / 60.0)
        M = _padd(
            _padd(a1, _pscale(a3, 1.0 / 12.0)),
            _pcomm(
                _padd(_padd(_pscale(a1, -20.0), a3, scale=-1.0), C1),
                _padd(a2, C2),
            ),
            scale=1.0 / 240.0,
        )

    monos = sorted(M.keys(), key=lambda m: (len(m), m))
    n_vars = len(nodes) * k
    deg_max = max(1, max(len(m) for m in monos))
    mon_index = np.full((len(monos), deg_max), n_vars, dtype=np.int32)
    for q, m in enumerate(monos):
        mon_index[q, : len(m)] = m
    X = np.stack([M[m] for m in monos], axis=0)
    return mon_index, X


_EXPANSION_CACHE: dict = {}


def _cached_expansion(static_op, operators, frame_diag, dt, magnus_order):
    S = np.asarray(static_op, dtype=np.complex128)
    ops = np.asarray(operators, dtype=np.complex128)
    d = (
        np.zeros(S.shape[0], dtype=np.complex128)
        if frame_diag is None
        else np.asarray(frame_diag, dtype=np.complex128)
    )
    key = (S.tobytes(), ops.tobytes(), d.tobytes(), float(dt), int(magnus_order))
    hit = _EXPANSION_CACHE.get(key)
    if hit is None:
        hit = expand_magnus_polynomial(S, ops, d, dt, magnus_order)
        _EXPANSION_CACHE[key] = hit
    return hit


# ---------------------------------------------------------------------------
# device engine


@functools.partial(
    jax.jit,
    static_argnames=("dt", "t0", "order", "magnus_order", "eval_slots"),
)
def _sweep_poly_jit(
    X_re,            # (Q, n*n) f
    X_im,
    mon_index,       # (Q, deg_max) int32
    d_im_hi, d_im_lo,  # (n,) imag part of frame diag, split
    coefficients,    # (T, n_gauss, k, B) real
    y0,              # (n, B) or (B, n, m) complex
    dt: float,
    t0: float,
    order: int,
    magnus_order: int,
    eval_slots=None,
):
    cplx = jnp.complex64 if not jax.config.jax_enable_x64 else jnp.complex128
    real = jnp.float32 if not jax.config.jax_enable_x64 else jnp.float64
    coef = jnp.asarray(coefficients).astype(real)
    T, n_gauss, k, B = coef.shape
    n = d_im_hi.shape[0]
    y0 = jnp.asarray(y0).astype(cplx)
    batch_major = y0.ndim == 3
    y = y0 if batch_major else jnp.swapaxes(y0, 0, 1)[..., None]  # (B, n, m)

    f32_mode = real == jnp.float32
    t_ref = 0.5

    def ref_phase(idx):
        """(n,) frame-diag phase d_im * (t0 + (idx + 0.5) dt), range-reduced
        in f32 mode (same EFT treatment as the other engines)."""
        if f32_mode:
            return reduced_phase(
                (d_im_hi, d_im_lo),
                step_time_df(
                    idx.astype(real), split_const(dt), split_const(t0 + t_ref * dt)
                ),
            )
        return (d_im_hi + d_im_lo) * (t0 + (idx.astype(real) + t_ref) * dt)

    n_eval = 0
    slots = None
    if eval_slots is not None:
        n_eval = _validate_eval_slots(eval_slots, T)
        slots = jnp.asarray(np.asarray(eval_slots, dtype=np.int32))

    Xr = jnp.asarray(X_re).astype(real)
    Xi = jnp.asarray(X_im).astype(real)
    mi = jnp.asarray(mon_index)

    def step(carry, xs):
        y, evals = carry
        idx, coef_step = xs  # coef_step (n_gauss, k, B)
        c_flat = coef_step.reshape(n_gauss * k, B)
        ones = jnp.ones((1, B), dtype=real)
        c_ext = jnp.concatenate([c_flat, ones], axis=0)
        mono = jnp.prod(c_ext[mi], axis=1)  # (Q, B)
        # ONE matmul per real/imag plane: (B, Q) @ (Q, n^2)
        monT = jnp.swapaxes(mono, 0, 1)
        Mr = (monT @ Xr).reshape(B, n, n)
        Mi = (monT @ Xi).reshape(B, n, n)
        # state into the step's reference frame: v = D^{-1} y
        ph = ref_phase(idx)
        Dinv = jnp.exp(-1j * ph.astype(cplx))[None, :, None]
        v = Dinv * y
        # v <- expm(M) v (identical polynomial to the xla engine)
        M = (Mr + 1j * Mi).astype(cplx)
        w = v
        for kk in range(order, 0, -1):
            w = v + jnp.einsum("bij,bjm->bim", M, w) / kk
        y_new = jnp.conj(Dinv) * w
        if n_eval > 0:
            slot = slots[idx]
            updated = jax.lax.dynamic_update_index_in_dim(
                evals, y_new, jnp.maximum(slot, 0), axis=0
            )
            evals = jnp.where(slot >= 0, updated, evals)
        return (y_new, evals), None

    evals0 = (
        jnp.zeros((n_eval,) + y.shape, dtype=y.dtype) if n_eval > 0 else jnp.zeros(())
    )
    (y, evals), _ = jax.lax.scan(
        jax.checkpoint(step), (y, evals0), (jnp.arange(T), coef)
    )
    if batch_major:
        return (y, evals) if n_eval > 0 else y
    y = jnp.swapaxes(y[..., 0], 0, 1)  # (n, B)
    if n_eval > 0:
        return y, jnp.moveaxis(evals[..., 0], 2, 1)
    return y


def sweep_expm_magnus_poly(
    static_op, operators, frame_diag, coefficients, y0,
    dt, t0=0.0, order=8, eval_slots=None, magnus_order=2,
):
    """Fixed-step Magnus sweep solve via the polynomial-expanded engine.

    Drop-in alternative to :func:`.xla_sweep.sweep_expm_magnus2_xla` (same
    step rule, same Horner polynomial, same coefficient-table contract) that
    replaces the per-member batched commutator matmuls with one
    ``(B, Q) @ (Q, n^2)`` contraction against host-precomputed expansion
    matrices — see the module docstring.

    Args:
        static_op: (n, n) static generator IN the frame eigenbasis, frame
            diagonal already subtracted (the engine contract).
        operators: (k, n, n) drive operators in the frame eigenbasis.
        frame_diag: (n,) frame eigenvalues ``d`` (anti-Hermitian part,
            i.e. purely imaginary), or ``None`` for no frame.
        coefficients: (T, n_gauss, k, B) real Gauss-point signal samples.
        y0: (n, B) complex column states or (B, n, m) batch-major.
        dt, t0: uniform step size and initial time.
        order: Horner Taylor order of the ``expm`` action.
        eval_slots: optional per-step trajectory store slots (as xla engine).
        magnus_order: 2 or 3.

    Returns:
        as :func:`.xla_sweep.sweep_expm_magnus2_xla`.
    """
    mon_index, X = _cached_expansion(
        static_op, operators, frame_diag, float(dt), int(magnus_order)
    )
    n = np.asarray(static_op).shape[0]
    d_im = (
        np.zeros(n, dtype=np.float64)
        if frame_diag is None
        else np.asarray(frame_diag, dtype=np.complex128).imag
    )
    d_hi = d_im.astype(np.float32)
    d_lo = (d_im - d_hi.astype(np.float64)).astype(np.float32)
    if jax.config.jax_enable_x64:
        d_hi, d_lo = d_im, np.zeros_like(d_im)
    Xf = X.reshape(X.shape[0], -1)
    return _sweep_poly_jit(
        Xf.real.copy(),
        Xf.imag.copy(),
        mon_index,
        d_hi, d_lo,
        coefficients, y0,
        dt=float(dt), t0=float(t0), order=int(order),
        magnus_order=int(magnus_order),
        eval_slots=None if eval_slots is None else tuple(int(s) for s in np.asarray(eval_slots)),
    )
