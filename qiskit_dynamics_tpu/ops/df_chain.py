r"""High-precision (df32) Dysolve stepping: the perturbative solvers' 1e-8 mode.

The f32 ``solve_sweep`` fast path floors at ~3e-6: 1000 sequential f32
propagator applications random-walk the matmul roundoff, while the identical
expansion evaluated in f64 on CPU sits at ~1e-8. This module reruns the SAME
truncated expansion with compensated double-float32 arithmetic
(``ops/df32.py``, ~2^-48 unit roundoff) so the arithmetic floor drops below
the expansion's own truncation error — the float32-hardware equivalent of
the reference running its perturbative solvers in CPU float64 (reference
accuracy bar:
``/root/reference/test/dynamics/common.py:65``; solver:
``/root/reference/qiskit_dynamics/solvers/perturbative_solvers/perturbative_solver.py:189-210``).

Where the bits go (measured term-magnitude ladder, bench Dysolve config —
dim-10 transmon, r=0.02, dt=0.1, expansion order 6):

====== ======= ==================== =================================
order  #terms  max step magnitude   arithmetic
====== ======= ==================== =================================
const        1  ~1 (Udt)            df32 (f32 would round at 6e-8/step)
1            4  4.5e-2              df32 (f32 error ~7e-10/step — too big)
2           10  4.2e-4              df32 (f32 error ~3e-11/step — marginal)
3+         194  <= 2.9e-6           plain f32 tensordot (error ~1e-12)
====== ======= ==================== =================================

So only ``constant + order<=df_order`` terms (15 of 209 at the default
``df_order=2``) pay the ~25x df32 elementwise cost; the tail keeps the f32
matmul path. The chain matvec runs in df32 throughout (per-step error ~1e-14,
1000-step random walk ~1e-12).

Coefficients must enter at better-than-f32 accuracy (the first-order term
multiplies them by ~1e-2 against a ~3e-10/step budget), so they are computed
HOST-side in f64. For the calibration-sweep pattern (fixed envelope shape,
member-scaled — the Dysolve bench config) the complex Chebyshev table
factorizes as ``C_b = s_b * C_ref``: only the (deg+1, T) reference table and
(B,) member scales ship as df pairs and the full (n_vars, T, B) table is
assembled ON DEVICE in df32 (the ``ops/df_sweep.py`` ``coef_factors``
pattern — the full table is O(T * B) host->device traffic). Non-factorizable
sweeps fall back to a per-member host loop + full-table shipping (correct,
slower; a warning names the cost).

Everything device-side is plain elementwise XLA inside one ``lax.scan``:
XLA fuses the long EFT chains itself.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import df32 as df

__all__ = ["dysolve_sweep_df"]


# ---------------------------------------------------------------------------
# df helpers on the ((re_hi, re_lo), (im_hi, im_lo)) complex representation


def _clift32(re, im):
    """Lift f32 real/imag planes into a df complex value (lo = 0)."""
    z = jnp.zeros_like(re)
    return (re, z), (im, jnp.zeros_like(im))


def _csum_axis(z, axis: int, n: int):
    """df-complex sum over an axis of static length ``n``.

    Log-depth pairwise fold of array HALVES (not per-index slices): XLA:CPU
    compile time scales with the op COUNT of the df chains (measured ~0.7 s
    per df-complex op at this shape), so ceil(log2 n) wide cadds beat n-1
    narrow ones ~3x in compile at identical numerics class."""

    def take(x, sl):
        idx = [slice(None)] * x.ndim
        idx[axis] = sl
        return x[tuple(idx)]

    cur, m = z, n
    while m > 1:
        h = m // 2
        lo = jax.tree_util.tree_map(lambda a: take(a, slice(0, h)), cur)
        hi = jax.tree_util.tree_map(lambda a: take(a, slice(h, 2 * h)), cur)
        s = df.cadd(lo, hi)
        if m % 2:
            rem = jax.tree_util.tree_map(lambda a: take(a, slice(2 * h, m)), cur)
            s = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b], axis=axis), s, rem
            )
            m = h + 1
        else:
            m = h
        cur = s
    return jax.tree_util.tree_map(
        lambda a: jax.lax.index_in_dim(a, 0, axis, keepdims=False), cur
    )


def _cmatvec_df(P, y, n: int):
    """out[i, b] = sum_m P[i, m, b] y[m, b] in df complex.

    ``P``: (n, n, B) df complex; ``y``: (n, B) df complex -> (n, B).
    Broadcast-multiply-reduce (batch-on-lanes rule: no dot_general on the
    lane-minor layout)."""
    yb = jax.tree_util.tree_map(lambda a: a[None, :, :], y)  # (1, n, B)
    prod = df.cmul(P, yb)  # (n, n, B)
    return _csum_axis(prod, 1, n)


# ---------------------------------------------------------------------------
# host-side: coefficient tables in f64


def _probe_times(t0: float, dt: float, n_steps: int, n: int = 64) -> np.ndarray:
    span = n_steps * dt
    return t0 + (np.arange(n) + 0.31) / n * span


def _rank1_dct_factors(model, signals_fn, params_np, t0: float, n_steps: int):
    """Factorize the sweep's complex DCT tables as ``C_b = s_b * C_ref``.

    Detection mirrors ``fused_sweep._rank1_envelope_factors``: every member's
    ``complex_value`` trajectory at 64 spread probe times must be
    complex-proportional to the loudest member's; scales come from a
    least-squares fit over the full probe trajectory. The reference member's
    table is then sampled host-f64 through the exact DCT machinery.

    Returns ``(C_ref_list, s)`` — per-signal (deg_j+1, n_steps) complex128
    tables and (k, B) complex128 member scales — or ``None`` (fall back to
    the per-member host loop) when construction fails, carriers/phases are
    per-member, envelopes sample at f32, or proportionality misses.
    """
    from ..solvers.perturbative_solvers.expansion_model import _signal_envelope_DCT

    B = jax.tree_util.tree_leaves(params_np)[0].shape[0]
    k = len(model.operators)
    try:
        sigs = list(signals_fn(params_np))
    except Exception:
        return None
    if len(sigs) != k:
        return None
    ts = _probe_times(t0, model.dt, n_steps)

    scales = np.zeros((k, B), dtype=np.complex128)
    bstars = []
    for j, s in enumerate(sigs):
        try:
            if np.asarray(s.carrier_freq).ndim > 0 or np.asarray(s.phase).ndim > 0:
                return None  # per-member carrier/phase: no shared table
            v = np.stack([np.asarray(s.complex_value(t)) for t in ts], axis=0)
        except Exception:
            return None
        if v.dtype != np.complex128:
            # jnp-written envelope sampling at f32: the 1e-8 contract cannot
            # hold; reject so the caller warns through the fallback path
            return None
        if v.shape != (len(ts), B):
            return None
        bstar = int(np.argmax(np.sum(np.abs(v), axis=0)))
        ref = v[:, bstar]
        denom = np.vdot(ref, ref).real
        if denom == 0.0:
            if np.max(np.abs(v)) != 0.0:
                return None
            scales[j] = 0.0
            bstars.append(bstar)
            continue
        s_b = (np.conj(ref) @ v) / denom  # (B,)
        resid = np.max(np.abs(v - ref[:, None] * s_b[None, :]))
        if resid > 1e-12 * max(np.max(np.abs(v)), 1e-300):
            return None
        scales[j] = s_b
        bstars.append(bstar)

    c_refs = []
    for j in range(k):
        try:
            ref_params = jax.tree_util.tree_map(
                lambda x: np.asarray(x)[bstars[j]], params_np
            )
            s_ref = list(signals_fn(ref_params))[j]
        except Exception:
            return None
        c_ref = np.asarray(
            _signal_envelope_DCT(
                s_ref,
                reference_freq=model._carrier_freqs[j],
                degree=model._chebyshev_orders[j],
                t0=t0,
                dt=model.dt,
                n_intervals=n_steps,
            ),
            dtype=np.complex128,
        )
        c_refs.append(c_ref)
    return c_refs, scales


def _full_table_f64(model, signals_fn, params_np, t0: float, n_steps: int):
    """Per-member host-f64 coefficient table, (n_vars, n_steps, B)."""
    leaves = jax.tree_util.tree_leaves(params_np)
    B = leaves[0].shape[0]
    cols = []
    warned_f32 = False
    for b in range(B):
        p_b = jax.tree_util.tree_map(lambda x: np.asarray(x)[b], params_np)
        c = np.asarray(model.approximate_signals(list(signals_fn(p_b)), t0, n_steps))
        if c.dtype != np.float64:
            if not warned_f32 and c.dtype in (np.float32, np.complex64):
                warnings.warn(
                    "df32 Dysolve sweep: signal envelopes sample at float32 "
                    "(jnp-written envelope with x64 disabled) — coefficient "
                    "accuracy is f32-limited and the 1e-8 contract cannot "
                    "hold. Write envelopes with numpy ops for full accuracy.",
                    stacklevel=3,
                )
                warned_f32 = True
            c = np.asarray(c, dtype=np.float64)
        cols.append(c)
    return np.stack(cols, axis=-1)


def _split_f64(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    hi = a.astype(np.float32)
    return hi, (a - hi.astype(np.float64)).astype(np.float32)


# ---------------------------------------------------------------------------
# device kernel (built once per static config, cached)

_KERNEL_CACHE: dict = {}


def _build_kernel(
    n: int,
    n_vars: int,
    low_index: Optional[np.ndarray],  # (K, Lmax_low) var indices, sentinel=n_vars
    tail_index: Optional[np.ndarray],
    blocks: Tuple[Tuple[int, int, bool], ...],  # per signal: (row0, deg+1, is_imag_present)
    expansion_method: str,
    expm_order: int,
    has_const: bool,
    rank1: bool,
):
    """Trace-once df32 stepping kernel for one static Dysolve configuration.

    Closes over only the static index matrices; all numeric data arrives as
    arguments so one compiled executable serves every chunk/call of the same
    shape. Every df stage is expressed as a few WIDE ops (batched gathers,
    one batched cmul_real, log-depth folds) rather than per-term chains:
    XLA:CPU compile time scales with df op count (~0.7 s/op measured), and
    wide elementwise ops also fuse better.
    """

    def kernel(
        # polynomial data (split planes)
        A_low,      # tuple of 4 arrays (K, n, n): re_hi, re_lo, im_hi, im_lo
        const_p,    # tuple of 4 arrays (n, n) or None-shaped zeros
        A_tail_re,  # (M_tail, n, n) f32 or None
        A_tail_im,
        udt_p,      # tuple of 4 arrays (n, n) (magnus only; zeros otherwise)
        # coefficients
        coef_data,  # rank1: (cref_hi, cref_lo re/im stacked, s planes); table: (c_hi, c_lo)
        # state
        y0_p,       # tuple of 4 arrays (n, B)
    ):
        if rank1:
            cref_re_hi, cref_re_lo, cref_im_hi, cref_im_lo, s_re_hi, s_re_lo, s_im_hi, s_im_lo = coef_data
            # assemble (n_vars, T, B) df real coefficient planes on device:
            # block rows of Re/Im(s_jb * C_ref_j[d, t]) in df arithmetic
            rows_hi, rows_lo = [], []
            for j, (row0, ndeg, inc_imag) in enumerate(blocks):
                cj = (
                    (cref_re_hi[j][:ndeg, :, None], cref_re_lo[j][:ndeg, :, None]),
                    (cref_im_hi[j][:ndeg, :, None], cref_im_lo[j][:ndeg, :, None]),
                )  # (deg+1, T, 1) df complex
                sj = (
                    (s_re_hi[j][None, None, :], s_re_lo[j][None, None, :]),
                    (s_im_hi[j][None, None, :], s_im_lo[j][None, None, :]),
                )  # (1, 1, B) df complex
                prod = df.cmul(sj, cj)  # (deg+1, T, B)
                rows_hi.append(prod[0][0])
                rows_lo.append(prod[0][1])
                if inc_imag:
                    rows_hi.append(prod[1][0])
                    rows_lo.append(prod[1][1])
            c_hi = jnp.concatenate(rows_hi, axis=0)
            c_lo = jnp.concatenate(rows_lo, axis=0)
        else:
            c_hi, c_lo = coef_data

        T = c_hi.shape[1]
        Bp = c_hi.shape[2]

        # f32 tail: monomials from hi coefficients, one tensordot
        if tail_index is not None:
            ones = jnp.ones((1, T, Bp), dtype=jnp.float32)
            c_ext = jnp.concatenate([c_hi, ones], axis=0)
            monos = jnp.prod(c_ext[jnp.asarray(tail_index)], axis=1)  # (M_tail, T, B)
            tail_re = jnp.tensordot(A_tail_re, monos, axes=(0, 0))  # (n, n, T, B)
            tail_im = jnp.tensordot(A_tail_im, monos, axes=(0, 0))
            tail_re = jnp.moveaxis(tail_re, 2, 0)  # (T, n, n, B)
            tail_im = jnp.moveaxis(tail_im, 2, 0)
        else:
            tail_re = jnp.zeros((T, n, n, Bp), dtype=jnp.float32)
            tail_im = tail_re

        # low-order monomials in df, ALL (term, step, lane) at once:
        # gather the (K, Lmax) factor columns and chain Lmax-1 wide df muls
        if low_index is not None:
            ones_hi = jnp.ones((1, T, Bp), dtype=jnp.float32)
            ce_hi = jnp.concatenate([c_hi, ones_hi], axis=0)
            ce_lo = jnp.concatenate([c_lo, jnp.zeros_like(ones_hi)], axis=0)
            li = jnp.asarray(low_index)
            m_low = (ce_hi[li[:, 0]], ce_lo[li[:, 0]])  # (K, T, B)
            for col in range(1, low_index.shape[1]):
                m_low = df.mul(m_low, (ce_hi[li[:, col]], ce_lo[li[:, col]]))
            # scan xs: (T, K, B)
            m_steps = jax.tree_util.tree_map(lambda a: jnp.moveaxis(a, 1, 0), m_low)
        else:
            m_steps = None

        A_low_c = ((A_low[0], A_low[1]), (A_low[2], A_low[3]))
        const_c = ((const_p[0], const_p[1]), (const_p[2], const_p[3]))
        udt_c = ((udt_p[0], udt_p[1]), (udt_p[2], udt_p[3]))

        def bcast_mat(m):
            return jax.tree_util.tree_map(lambda a: a[:, :, None], m)

        const_b = bcast_mat(const_c)
        udt_b = bcast_mat(udt_c)
        # A_low broadcast to (K, n, n, 1)
        A_low_b = jax.tree_util.tree_map(lambda a: a[:, :, :, None], A_low_c)
        K = A_low[0].shape[0]

        inv_k = [
            df.from_f64(np.float64(1.0) / np.float64(kk))
            for kk in range(1, expm_order + 1)
        ]

        def step(y, xs):
            m_t, tr, ti = xs
            # P = lift(tail) [+ const] + sum_low A_I m_I   (df complex, (n,n,B))
            P = _clift32(tr, ti)
            if has_const:
                P = df.cadd(P, const_b)
            if K:
                mb = jax.tree_util.tree_map(lambda a: a[:, None, None, :], m_t)
                terms = df.cmul_real(A_low_b, mb)  # (K, n, n, B) df complex
                P = df.cadd(P, _csum_axis(terms, 0, K))

            if expansion_method == "dyson":
                y_new = _cmatvec_df(P, y, n)
            else:
                # y <- Udt @ expm(P) y, Horner action:
                # v = y + P v / k for k = order..1
                v = y
                for kk in range(expm_order, 0, -1):
                    w = _cmatvec_df(P, v, n)
                    w = (df.mul(w[0], inv_k[kk - 1]), df.mul(w[1], inv_k[kk - 1]))
                    v = df.cadd(y, w)
                y_new = _cmatvec_df(udt_b, v, n)
            return y_new, None

        y0_c = ((y0_p[0], y0_p[1]), (y0_p[2], y0_p[3]))
        if m_steps is None:
            m_steps = (
                jnp.zeros((T, 0, Bp), jnp.float32),
                jnp.zeros((T, 0, Bp), jnp.float32),
            )
        yf, _ = jax.lax.scan(step, y0_c, (m_steps, tail_re, tail_im))
        return yf[0][0], yf[0][1], yf[1][0], yf[1][1]

    return jax.jit(kernel)


# ---------------------------------------------------------------------------
# public entry


def dysolve_sweep_df(
    model,
    signals_fn: Callable,
    params,
    y0,
    t0: float,
    n_steps: int,
    df_order: int = 2,
    expm_order: int = 12,
    chunk_b: int = 2048,
    devices=None,
) -> np.ndarray:
    """Batched Dysolve sweep in compensated df32 arithmetic (~1e-8 class).

    Evaluates the SAME truncated Dyson/Magnus expansion as the f32
    ``solve_sweep`` fast path, but with the constant and order<=``df_order``
    terms, the coefficient tables, and the whole propagator chain in df32
    (see the module docstring's error budget). Host-synchronous: parameters
    must be concrete (the coefficient tables are sampled host-side in f64),
    and signal envelopes should be written with ``numpy`` ops so host
    sampling is f64 (jnp-written envelopes sample at f32 and the mode falls
    back to f32-limited tables with a warning).

    Args:
        model: the solver's :class:`ExpansionModel`.
        signals_fn: maps one parameter pytree -> signal list. Must accept the
            full batched parameter array for the rank-1 fast path (the
            amplitude-calibration pattern); per-member construction is the
            fallback.
        params: (B,)-leading concrete parameter array/pytree.
        y0: shared initial state, shape (dim,).
        t0: shared initial time.
        n_steps: number of steps of size ``model.dt``.
        df_order: highest expansion order evaluated in df32 (default 2; the
            f32 tail error is ~(r*dt)^(df_order+1) * 6e-8 per step).
        expm_order: Taylor order of the Magnus per-step ``expm`` action.
        chunk_b: member-chunk width per device dispatch.
        devices: optional list of ``jax.Device`` — chunk dispatches
            round-robin across them with per-device invariant tables
            (host-fed data parallelism, the ``ops/df_sweep.py`` multi-chip
            pattern); transfers are deferred so devices run concurrently.

    Returns:
        (B, dim) complex128 final states in the model's rotating frame
        (the ``solve``/``solve_sweep`` convention), as a host numpy array.
    """
    poly = model.expansion_polynomial
    labels = [tuple(sorted(l)) for l in poly.monomial_labels]
    A = np.asarray(poly.array_coefficients, dtype=np.complex128)
    n = A.shape[1]
    method = model.expansion_method

    params_np = jax.tree_util.tree_map(np.asarray, params)
    flat_leaves = jax.tree_util.tree_leaves(params_np)
    B = flat_leaves[0].shape[0]

    # block layout of the stacked real/imag coefficient rows
    blocks = []
    row = 0
    for j in range(len(model.operators)):
        ndeg = model._chebyshev_orders[j] + 1
        inc = bool(model._include_imag[j])
        blocks.append((row, ndeg, inc))
        row += ndeg * (2 if inc else 1)
    n_vars = row

    # --- host: split polynomial terms by order --------------------------
    low_idx = [i for i, l in enumerate(labels) if len(l) <= df_order]
    tail_idx = [i for i, l in enumerate(labels) if len(l) > df_order]
    A_low = A[low_idx] if low_idx else np.zeros((0, n, n), dtype=np.complex128)
    if low_idx:
        lmax_low = max(1, max(len(labels[i]) for i in low_idx))
        # sentinel n_vars gathers the appended ones-row
        low_index = np.full((len(low_idx), lmax_low), n_vars, dtype=np.int32)
        for r, i in enumerate(low_idx):
            lab = labels[i]
            low_index[r, : len(lab)] = lab
    else:
        low_index = None
    if tail_idx:
        max_len = max(len(labels[i]) for i in tail_idx)
        # sentinel = n_vars: gathers the ones-row appended after the real
        # coefficient rows at evaluation time
        tail_index = np.full((len(tail_idx), max_len), n_vars, dtype=np.int32)
        for r, i in enumerate(tail_idx):
            tail_index[r, : len(labels[i])] = labels[i]
        A_tail = A[tail_idx]
        A_tail_re = A_tail.real.astype(np.float32)
        A_tail_im = A_tail.imag.astype(np.float32)
    else:
        tail_index = None
        A_tail_re = A_tail_im = None

    const = poly.constant_term
    has_const = const is not None
    const64 = (
        np.asarray(const, dtype=np.complex128)
        if has_const
        else np.zeros((n, n), dtype=np.complex128)
    )
    udt64 = np.asarray(model.Udt, dtype=np.complex128)

    # --- host: coefficients in f64 --------------------------------------
    rank1 = _rank1_dct_factors(model, signals_fn, params_np, t0, n_steps)
    if rank1 is None:
        if B > 256:
            warnings.warn(
                "df32 Dysolve sweep: parameter sweep did not factorize as "
                "rank-1 (fixed envelope shape x member scale); falling back "
                f"to a per-member host f64 table ({B} members — host "
                "sampling + table shipping dominate the runtime).",
                stacklevel=2,
            )
        table = _full_table_f64(model, signals_fn, params_np, t0, n_steps)
        if table.shape[0] != n_vars:
            raise ValueError(
                f"coefficient table has {table.shape[0]} rows, expected {n_vars}"
            )

    # --- device kernel (cached per static config) ------------------------
    key = (
        n, n_vars,
        None if low_index is None else low_index.tobytes(),
        None if tail_index is None else tail_index.tobytes(),
        tuple(blocks), method, expm_order, has_const, rank1 is not None,
    )
    kernel = _KERNEL_CACHE.get(key)
    if kernel is None:
        kernel = _build_kernel(
            n, n_vars, low_index, tail_index, tuple(blocks),
            method, expm_order, has_const, rank1 is not None,
        )
        _KERNEL_CACHE[key] = kernel

    def split4(z64):
        return (*_split_f64(z64.real), *_split_f64(z64.imag))

    # frame sandwich host-side in f64
    U0 = np.asarray(
        model.rotating_frame.state_out_of_frame(t0, np.eye(n, dtype=complex))
    )
    Uf = np.asarray(
        model.rotating_frame.state_into_frame(
            t0 + n_steps * model.dt, np.eye(n, dtype=complex)
        )
    )
    y0_vec = U0 @ np.asarray(y0, dtype=np.complex128)

    # per-device invariant tables shipped ONCE (with multiple devices the
    # chunk dispatches round-robin)
    dev_list = list(devices) if devices else [None]

    def _dput(x, d):
        return (
            jax.tree_util.tree_map(lambda a: jax.device_put(a, d), x)
            if d is not None
            else x
        )

    zero_tail = np.zeros((0, n, n), dtype=np.float32)
    invariants = []
    for d in dev_list:
        wp0 = chunk_b if B > chunk_b else B
        y0_cols = np.broadcast_to(y0_vec[:, None], (n, wp0)).copy()
        inv = dict(
            A_low_p=_dput(split4(A_low), d),
            const_p=_dput(split4(const64), d),
            udt_p=_dput(split4(udt64), d),
            tail_re=_dput(A_tail_re if tail_index is not None else zero_tail, d),
            tail_im=_dput(A_tail_im if tail_index is not None else zero_tail, d),
            y0_p=_dput(split4(y0_cols), d),
        )
        if rank1 is not None:
            c_refs, scales = rank1
            deg_max = max(c.shape[0] for c in c_refs)
            k = len(c_refs)
            cref = np.zeros((k, deg_max, n_steps), dtype=np.complex128)
            for j, c in enumerate(c_refs):
                cref[j, : c.shape[0]] = c
            inv["cref_p"] = _dput(split4(cref), d)
        invariants.append(inv)

    # --- chunked dispatch (deferred pulls: all chunks enqueue before the
    # first result transfers back, so devices run concurrently) -----------
    out = np.zeros((B, n), dtype=np.complex128)
    pending = []
    for ci, c0 in enumerate(range(0, B, chunk_b)):
        c1 = min(c0 + chunk_b, B)
        w = c1 - c0
        wp = chunk_b if B > chunk_b else w  # pad only multi-chunk runs
        d = dev_list[ci % len(dev_list)]
        inv = invariants[ci % len(dev_list)]

        if rank1 is not None:
            _, scales = rank1
            s_chunk = np.zeros((len(rank1[0]), wp), dtype=np.complex128)
            s_chunk[:, :w] = scales[:, c0:c1]
            coef_data = (*inv["cref_p"], *_dput(split4(s_chunk), d))
        else:
            t_chunk = np.zeros((n_vars, n_steps, wp), dtype=np.float64)
            t_chunk[:, :, :w] = table[:, :, c0:c1]
            coef_data = _dput(_split_f64(t_chunk), d)

        res = kernel(
            inv["A_low_p"], inv["const_p"], inv["tail_re"], inv["tail_im"],
            inv["udt_p"], coef_data, inv["y0_p"],
        )
        pending.append((c0, c1, w, res))
    for c0, c1, w, (rh, rl, ih, il) in pending:
        yf = (
            np.asarray(rh, dtype=np.float64)
            + np.asarray(rl, dtype=np.float64)
            + 1j * (np.asarray(ih, dtype=np.float64) + np.asarray(il, dtype=np.float64))
        )
        out[c0:c1] = (Uf @ yf[:, :w]).T
    return out
