r"""Lockstep-adaptive Dormand-Prince sweeps: a Triton kernel and its XLA twin.

Solves ``y'_b = G_b(t) y_b`` for a sweep of members with a SHARED adaptive
time grid per group of ``tile_b`` members: a step is accepted when the worst
member of the group passes the tolerance, so the group advances together
("lockstep"). For parameter sweeps of one model this is as accurate as
per-member adaptivity (the error control follows the stiffest member).

Two engines run the same integration:

- :func:`_lockstep_triton` — a Pallas kernel through Triton, one program per
  group, the whole adaptive loop on chip: no per-step launches and no
  per-step read-back of the loop predicate. The time ``t`` is shared by the
  group, so with the frame conjugation ``G(t) y = D^{-1} (S + sum_j c_j(t, b)
  O_j) D y`` (``D = diag(e^{i w t})``) every stage is ``k + 1`` products of
  the constant ``(n, n)`` operators with the ``(n, tile_b)`` state block
  (``jnp.dot`` in full f32, never TF32). ``n`` is padded to a power of two of
  at least 16 (Triton's block rule); the error norm still averages over the
  ``n`` real entries.
- :func:`_lockstep_xla` — the same controller and grouping in plain XLA (a
  ``while_loop`` over all groups at once). It is the reference the kernel is
  tested against, and the engine wherever no GPU is present.

Signal model: constant-envelope signals ``c_j(t, b) = Re[A_j(b) e^{i w_j t}]``
with a per-member complex amplitude, or piecewise-constant per-member envelope
TABLES (``(k, S, B)`` + ``env_dt``). In table mode steps are clipped to
envelope-cell boundaries and every stage of a step reads the cell at the step
midpoint, so the RHS is smooth within each step and dopri5 keeps its order
across sample discontinuities.

Error control follows ``tpu_dopri5`` (solvers/adaptive.py): rms over state
entries of ``err/scale`` with ``scale = atol + rtol*max(|y|,|y_new|)``, max
over the group; step factor ``clip(0.9 err^(-1/5), 0.2, 10)`` (shrink-only on
rejection), a small-step stall guard, and FSAL reuse of the 7th stage. If the
step budget runs out before ``tf``, the group's output is NaN-poisoned (the
in-graph error convention used across the framework).

Precision: both engines run float32 regardless of ``jax_enable_x64``, with
time tracked as an f32 (hi, lo) pair and phase arguments formed by EFT
products reduced mod 2pi (``ops/trig_reduce.py``), so large absolute phases
cost no accuracy. Tolerances are honored down to ~1e-7-class; below ~3e-8
the error estimate is f32-roundoff-dominated.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .rk_tableaus import (
    DOPRI5_A as _A,        # (6, 5) stage coefficients (explicit)
    DOPRI5_B as _B,        # (6,) solution weights
    DOPRI5_C as _C,        # (6,) stage times
    DOPRI5_E as _E,        # (7,) error weights (incl. FSAL stage)
    DOPRI5_N_STAGES as _N_STAGES,
)
from .trig_reduce import reduced_phase, split_array, split_const, time_add, time_add_df

__all__ = ["sweep_dopri5_lockstep", "lockstep_engine", "lockstep_tile_b"]

_EPS32 = 1.1920929e-7


def lockstep_tile_b(n: int) -> int:
    """Default lockstep group size (members per Triton program) for an
    ``n``-dim state: a ``(n_pad, tile_b)`` block of 512 elements, so 32
    members at ``n <= 16`` and 16 above.

    On one H100 80GB HBM3 the kernel's time follows the block elements per
    thread, ``n_pad * tile_b / (32 * warps)``: the dim-16 10k-member sweep
    took 4.2 ms at tile 32 with 8 warps, 4.4-4.7 ms at tile 16, 10.4 ms at 4
    elements per thread and 20 ms at 8 (400 W limit; 129 ms at tile 128 with
    4 warps, 700 W), and the dim-27 serving batch took 58-64 ms at tile 16
    against 116-141 ms at tile 32 (400 W). The XLA twin takes 13.5-14.5 ms
    on the dim-16 sweep at every group size."""
    return max(16, 512 // _pad_dim(n))


def lockstep_engine(interpret: bool = False) -> str:
    """The engine :func:`sweep_dopri5_lockstep` runs: ``"triton"`` on a GPU
    (or in the Pallas interpreter when ``interpret``), ``"xla"`` elsewhere."""
    if interpret or jax.default_backend() == "gpu":
        return "triton"
    return "xla"


def _triton_warps(n_pad: int, tile_b: int) -> int:
    """Warps per Triton program: about 2 block elements per thread (see
    :func:`lockstep_tile_b`), between 4 and 16 warps."""
    return int(min(16, max(4, n_pad * tile_b // 64)))


def _pad_dim(n: int) -> int:
    """Triton block rows: a power of two of at least 16 (its ``dot`` minimum)."""
    return max(16, 1 << (int(n) - 1).bit_length())


# ---------------------------------------------------------------------------
# controller shared by both engines (per-group scalars: () in the kernel,
# (L,) in the XLA engine)


def _clip_step(s_hi, s_lo, h_prop, eidx, dur, n_eval, target_at, n_env, env_dt):
    """Step size for this attempt and the envelope cell all its stages read."""
    gap = (dur[0] - s_hi) + (dur[1] - s_lo)
    h = jnp.minimum(h_prop, gap)
    target = have_target = None
    if n_eval > 0:
        # clip to the next trajectory time so an accepted step lands on it
        target = target_at(jnp.minimum(eidx, n_eval - 1))
        have_target = eidx < n_eval
        h = jnp.where(have_target, jnp.minimum(h, jnp.maximum(target - s_hi, 0.0)), h)
    if n_env > 1:
        # clip to the next envelope-cell boundary; all stages read the cell
        # at the step midpoint (the +1e-4 nudge tolerates t rounding just
        # below a boundary)
        inv = 1.0 / env_dt
        cell_f = jnp.floor(s_hi * inv + 1e-4)
        h = jnp.minimum(h, (cell_f + 1.0) * jnp.float32(env_dt) - s_hi)
        cell = jnp.clip(((s_hi + 0.5 * h) * inv).astype(jnp.int32), 0, n_env - 1)
    else:
        cell = jnp.zeros(jnp.shape(s_hi), jnp.int32)
    return h, cell, target, have_target


def _cell_at(s_hi, n_env, env_dt):
    return jnp.clip(
        jnp.floor(s_hi * (1.0 / env_dt) + 1e-4).astype(jnp.int32), 0, n_env - 1
    )


def _adapt(h, h_prop, err_norm, s_hi, clipping: bool):
    """Accept/reject, the stall flag, and the next proposal."""
    # a step within a few ulps of t cannot be refined further: accept it,
    # and flag it if it is wildly out of tolerance (NaN-poisons the output)
    stalled = h <= (4.0 * _EPS32) * jnp.maximum(1.0, s_hi)
    accept = (err_norm <= 1.0) | stalled
    bad = stalled & (err_norm > 100.0)
    # err^(-1/5) via exp/log; growth capped at 10, shrink-only on reject
    safe_err = jnp.maximum(err_norm, jnp.float32(1e-10))
    factor = jnp.clip(0.9 * jnp.exp(-0.2 * jnp.log(safe_err)), 0.2, 10.0)
    factor = jnp.where(accept, factor, jnp.minimum(factor, 1.0))
    h_new = h * factor
    if clipping:
        # a boundary-clipped accepted step must not shrink the proposal
        h_new = jnp.where(accept & (h < h_prop), jnp.maximum(h_prop, h_new), h_new)
    return accept, bad, h_new


def _stage_combo(y, ks, coeffs, h):
    """``y + h * sum_q coeffs[q] ks[q]`` (zero coefficients skipped; no
    ``y`` term when ``y`` is None)."""
    acc = None
    for c, kq in zip(coeffs, ks):
        c = float(c)
        if c != 0.0:
            term = c * kq
            acc = term if acc is None else acc + term
    return h * acc if y is None else y + h * acc


class _ReIm(tuple):
    """A (re, im) pair of real blocks with the sums and scalings
    :func:`_dopri5_step` performs (the Triton kernel has no complex type)."""

    def __add__(self, other):
        return _ReIm((self[0] + other[0], self[1] + other[1]))

    def __rmul__(self, a):
        return _ReIm((a * self[0], a * self[1]))


def _dopri5_step(rhs, y, k0, s_pair, h, cell, hb):
    """One dopri5 attempt from FSAL stage ``k0``: ``(y_new, err, k6)``.

    ``rhs(y, s_pair, cell)`` evaluates the generator; ``hb`` is ``h``
    broadcast against the state. States are complex arrays or
    :class:`_ReIm` pairs."""
    ks = [k0]
    for s in range(1, _N_STAGES):
        arg = _stage_combo(y, ks, _A[s, :s], hb)
        ks.append(rhs(arg, time_add(s_pair, jnp.float32(_C[s]) * h), cell))
    y_new = _stage_combo(y, ks, _B, hb)
    k6 = rhs(y_new, time_add(s_pair, h), cell)
    ks.append(k6)
    err = _stage_combo(None, ks, _E, hb)
    return y_new, err, k6


# ---------------------------------------------------------------------------
# plain-XLA engine (reference; engine off the GPU) and the replay's RHS


def lockstep_rhs(static, ops, w_pair, fr_pair, t0_pair, amps_t):
    """``G(t) y`` for ``(L, Bt, n)`` complex states with per-group times.

    ``G y = D^{-1} (S + sum_j c_j O_j) D y`` with ``D = diag(e^{i w t})`` and
    ``c_j = Re[E_j(cell) e^{i w_j t}]``; ``amps_t`` is the ``(k, n_env, L,
    Bt)`` envelope table. Shared by the XLA engine and the AD replay
    (``ops/adaptive_replay.py``)."""
    c64 = jnp.complex64
    t0_df = (jnp.float32(t0_pair[0]), jnp.float32(t0_pair[1]))

    def rhs(y, s_pair, cell):
        st = time_add_df(s_pair, t0_df)
        st = (st[0][:, None], st[1][:, None])
        ph_w = reduced_phase((w_pair[0][None, :], w_pair[1][None, :]), st)  # (L, n)
        d_plus = jax.lax.complex(jnp.cos(ph_w), jnp.sin(ph_w))
        ph_c = reduced_phase((fr_pair[0][None, :], fr_pair[1][None, :]), st)  # (L, k)
        carrier = jax.lax.complex(jnp.cos(ph_c), jnp.sin(ph_c))
        env = jnp.take_along_axis(amps_t, cell[None, None, :, None], axis=1)[:, 0]
        coeff = jnp.real(env * jnp.swapaxes(carrier, 0, 1)[:, :, None])  # (k, L, Bt)
        u = y * d_plus[:, None, :]
        au = jnp.einsum("nm,lbm->lbn", static, u)
        if ops.shape[0]:
            ou = jnp.einsum("jnm,lbm->jlbn", ops, u)
            au = au + jnp.einsum("jlb,jlbn->lbn", coeff.astype(c64), ou)
        return au * jnp.conj(d_plus)[:, None, :]

    return rhs


@functools.partial(
    jax.jit,
    static_argnames=(
        "tf", "t0", "atol", "rtol", "max_steps", "h0", "tile_b", "env_dt", "eval_ts",
    ),
)
def _lockstep_xla(
    static_op, operators, w_hi, w_lo, fr_hi, fr_lo, amps, y0, *,
    tf, t0, atol, rtol, max_steps, h0, tile_b, env_dt, eval_ts,
):
    """XLA twin of :func:`_lockstep_triton`; returns the same raw tuple."""
    f32, c64 = jnp.float32, jnp.complex64
    static = jnp.asarray(static_op).astype(c64)
    ops = jnp.asarray(operators).astype(c64)
    k, n, _ = ops.shape
    amps = jnp.asarray(amps).astype(c64)
    n_env = amps.shape[1]
    y0 = jnp.asarray(y0).astype(c64)
    B = y0.shape[1]
    L = B // tile_b
    dur = tuple(jnp.float32(v) for v in split_const(float(tf) - float(t0)))
    n_eval = 0 if eval_ts is None else len(eval_ts)
    targets = None if eval_ts is None else jnp.asarray(np.asarray(eval_ts, np.float32))
    rhs = lockstep_rhs(
        static, ops,
        (jnp.asarray(w_hi, f32), jnp.asarray(w_lo, f32)),
        (jnp.asarray(fr_hi, f32).reshape(k), jnp.asarray(fr_lo, f32).reshape(k)),
        split_const(float(t0)), amps.reshape(k, n_env, L, tile_b),
    )
    groups = jnp.arange(L)

    y = jnp.moveaxis(y0, 0, -1).reshape(L, tile_b, n)
    zeros = jnp.zeros(L, f32)
    izeros = jnp.zeros(L, jnp.int32)
    k0 = rhs(y, (zeros, zeros), izeros)

    def remaining(s_hi, s_lo):
        return (dur[0] - s_hi) + (dur[1] - s_lo)

    def cond(carry):
        _, _, s_hi, s_lo, _, steps, *_ = carry
        return jnp.any((remaining(s_hi, s_lo) > 0.0) & (steps < max_steps))

    def body(carry):
        y, k0, s_hi, s_lo, h_prop, steps, bad, eidx, aidx, evals, rec = carry
        active = (remaining(s_hi, s_lo) > 0.0) & (steps < max_steps)
        h, cell, target, have_target = _clip_step(
            s_hi, s_lo, h_prop, eidx, dur, n_eval, lambda i: targets[i], n_env, env_dt
        )
        y_new, err, k6 = _dopri5_step(
            rhs, y, k0, (s_hi, s_lo), h, cell, h[:, None, None]
        )
        scale = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y_new))
        err_sq = jnp.sum(jnp.abs(err) ** 2 / scale**2, axis=-1)  # (L, Bt)
        err_norm = jnp.sqrt(jnp.max(err_sq, axis=-1) / n)
        accept, stall_bad, h_new = _adapt(
            h, h_prop, err_norm, s_hi, n_env > 1 or n_eval > 0
        )
        accept = accept & active
        bad = bad | (stall_bad & active)
        acc3 = accept[:, None, None]
        y = jnp.where(acc3, y_new, y)
        k0 = jnp.where(acc3, k6, k0)
        # every attempt writes its slot; the count of accepted steps masks
        # the slot a rejected attempt left behind
        rec = rec.at[groups, jnp.minimum(aidx, max_steps - 1)].set(h)
        aidx = aidx + accept.astype(jnp.int32)
        s_next = time_add((s_hi, s_lo), h)
        s_hi_new = jnp.where(accept, s_next[0], s_hi)
        s_lo_new = jnp.where(accept, s_next[1], s_lo)
        if n_env > 1:
            # FSAL stage 6 used the old cell; a step that landed on a cell
            # boundary needs stage 0 from the new cell
            new_cell = _cell_at(s_hi_new, n_env, env_dt)
            crossed = (
                accept & (new_cell != cell) & (remaining(s_hi_new, s_lo_new) > 0.0)
            )
            k0 = jax.lax.cond(
                jnp.any(crossed),
                lambda: jnp.where(
                    crossed[:, None, None], rhs(y, (s_hi_new, s_lo_new), new_cell), k0
                ),
                lambda: k0,
            )
        if n_eval > 0:
            eps = (4.0 * _EPS32) * jnp.maximum(1.0, target)
            reached = have_target & accept & (s_hi_new >= target - eps)
            slot = jnp.minimum(eidx, n_eval - 1)
            evals = evals.at[slot, groups].set(
                jnp.where(reached[:, None, None], y, evals[slot, groups])
            )
            eidx = eidx + reached.astype(jnp.int32)
        h_prop = jnp.where(active, h_new, h_prop)
        steps = steps + active.astype(jnp.int32)
        return y, k0, s_hi_new, s_lo_new, h_prop, steps, bad, eidx, aidx, evals, rec

    evals0 = (
        jnp.zeros((n_eval, L, tile_b, n), c64) if n_eval > 0 else jnp.zeros((), c64)
    )
    carry = (
        y, k0, zeros, zeros, jnp.full(L, h0, f32), izeros, jnp.zeros(L, bool),
        izeros, izeros, evals0, jnp.zeros((L, max_steps), f32),
    )
    y, _, s_hi, s_lo, _, steps, bad, eidx, aidx, evals, rec = jax.lax.while_loop(
        cond, body, carry
    )
    ok = (remaining(s_hi, s_lo) <= 0.0) & ~bad & (eidx >= n_eval)
    info = jnp.stack([ok.astype(jnp.int32), steps, aidx], axis=1)
    y_out = jnp.moveaxis(y.reshape(B, n), 0, 1)
    ev_out = (
        jnp.moveaxis(evals.reshape(n_eval, B, n), 1, 2) if n_eval > 0 else None
    )
    return y_out, ev_out, rec, info


# ---------------------------------------------------------------------------
# Triton kernel: one program per lockstep group


def _triton_kernel(
    n: int, k: int, n_env: int, env_dt: float, t0_pair: tuple, dur_pair: tuple,
    atol: float, rtol: float, max_steps: int, h0: float, n_eval: int, tile_b: int,
    *refs,
):
    sr_ref, si_ref, opr_ref, opi_ref, w_ref, fr_ref, envr_ref, envi_ref = refs[:8]
    pos = 8
    tev_ref = None
    if n_eval > 0:
        tev_ref = refs[pos]                       # (n_eval,) elapsed times
        pos += 1
    y0r_ref, y0i_ref, outr_ref, outi_ref = refs[pos:pos + 4]
    pos += 4
    if n_eval > 0:
        evr_ref, evi_ref = refs[pos:pos + 2]      # (n_eval, n_pad, B)
        pos += 2
    rec_ref, info_ref = refs[pos:pos + 2]         # (L, max_steps), (L, 3)

    f32 = jnp.float32
    g = pl.program_id(0)
    cols = pl.ds(g * tile_b, tile_b)
    dur = (f32(dur_pair[0]), f32(dur_pair[1]))
    t0_df = (f32(t0_pair[0]), f32(t0_pair[1]))
    w_pair = (w_ref[0, :][:, None], w_ref[1, :][:, None])  # (n_pad, 1)
    dot = functools.partial(
        jnp.dot, precision=jax.lax.Precision.HIGHEST, preferred_element_type=f32
    )

    def envelope(cell):
        return [(envr_ref[j, cell, cols], envi_ref[j, cell, cols]) for j in range(k)]

    def rhs(y, s_pair, env):
        """(re, im) ``G(t) y`` for the (n_pad, tile_b) block."""
        yr, yi = y
        st = time_add_df(t0_df, s_pair)
        ph = reduced_phase(w_pair, st)
        c, s = jnp.cos(ph), jnp.sin(ph)
        ur, ui = c * yr - s * yi, s * yr + c * yi
        mr, mi = sr_ref[...], si_ref[...]
        ar = dot(mr, ur) - dot(mi, ui)
        ai = dot(mr, ui) + dot(mi, ur)
        for j in range(k):
            phj = reduced_phase((fr_ref[0, j], fr_ref[1, j]), st)
            er, ei = env[j]
            cj = (er * jnp.cos(phj) - ei * jnp.sin(phj))[None, :]
            mr, mi = opr_ref[j], opi_ref[j]
            ar = ar + cj * (dot(mr, ur) - dot(mi, ui))
            ai = ai + cj * (dot(mr, ui) + dot(mi, ur))
        return c * ar + s * ai, c * ai - s * ar

    def target_at(i):
        return tev_ref[i]

    def remaining(s_hi, s_lo):
        return (dur[0] - s_hi) + (dur[1] - s_lo)

    env0 = envelope(0)

    def cond(carry):
        _, _, s_hi, s_lo, _, steps, *_ = carry
        return (remaining(s_hi, s_lo) > 0.0) & (steps < max_steps)

    def body(carry):
        y, k0, s_hi, s_lo, h_prop, steps, bad, eidx, aidx = carry
        h, cell, target, have_target = _clip_step(
            s_hi, s_lo, h_prop, eidx, dur, n_eval, target_at, n_env, env_dt
        )
        env = envelope(cell) if n_env > 1 else env0
        y_new, err, k6 = _dopri5_step(
            lambda yy, sp, _c: _ReIm(rhs(yy, sp, env)), _ReIm(y), _ReIm(k0),
            (s_hi, s_lo), h, cell, h,
        )
        abs_y = jnp.sqrt(y[0] ** 2 + y[1] ** 2)
        abs_w = jnp.sqrt(y_new[0] ** 2 + y_new[1] ** 2)
        scale = atol + rtol * jnp.maximum(abs_y, abs_w)
        err_sq = jnp.sum((err[0] ** 2 + err[1] ** 2) / (scale * scale), axis=0)
        err_norm = jnp.sqrt(jnp.max(err_sq) / n)
        accept, stall_bad, h_new = _adapt(
            h, h_prop, err_norm, s_hi, n_env > 1 or n_eval > 0
        )
        bad = bad | stall_bad
        y = tuple(jnp.where(accept, a, b) for a, b in zip(y_new, y))
        k0 = tuple(jnp.where(accept, a, b) for a, b in zip(k6, k0))

        @pl.when(accept)
        def _record():
            rec_ref[g, aidx] = h

        aidx = aidx + accept.astype(jnp.int32)
        s_next = time_add((s_hi, s_lo), h)
        s_hi_new = jnp.where(accept, s_next[0], s_hi)
        s_lo_new = jnp.where(accept, s_next[1], s_lo)
        if n_env > 1:
            new_cell = _cell_at(s_hi_new, n_env, env_dt)
            crossed = (
                accept & (new_cell != cell) & (remaining(s_hi_new, s_lo_new) > 0.0)
            )
            k0 = jax.lax.cond(
                crossed,
                lambda: rhs(y, (s_hi_new, s_lo_new), envelope(new_cell)),
                lambda: k0,
            )
        if n_eval > 0:
            eps = (4.0 * _EPS32) * jnp.maximum(1.0, target)
            reached = have_target & accept & (s_hi_new >= target - eps)

            @pl.when(reached)
            def _store():
                evr_ref[eidx, :, cols] = y[0]
                evi_ref[eidx, :, cols] = y[1]

            eidx = eidx + reached.astype(jnp.int32)
        return y, k0, s_hi_new, s_lo_new, h_new, steps + 1, bad, eidx, aidx

    y0 = (y0r_ref[:, cols], y0i_ref[:, cols])
    zero = f32(0.0)
    k0 = rhs(y0, (zero, zero), env0)
    i0 = jnp.int32(0)
    y, _, s_hi, s_lo, _, steps, bad, eidx, aidx = jax.lax.while_loop(
        cond, body, (y0, k0, zero, zero, f32(h0), i0, jnp.bool_(False), i0, i0)
    )
    outr_ref[:, cols] = y[0]
    outi_ref[:, cols] = y[1]
    ok = (remaining(s_hi, s_lo) <= 0.0) & jnp.logical_not(bad) & (eidx >= n_eval)
    info_ref[g, 0] = ok.astype(jnp.int32)
    info_ref[g, 1] = steps
    info_ref[g, 2] = aidx


@functools.partial(
    jax.jit,
    static_argnames=(
        "tf", "t0", "atol", "rtol", "max_steps", "h0", "tile_b", "env_dt", "eval_ts",
        "interpret",
    ),
)
def _lockstep_triton(
    static_op, operators, w_hi, w_lo, fr_hi, fr_lo, amps, y0, *,
    tf, t0, atol, rtol, max_steps, h0, tile_b, env_dt, eval_ts, interpret=False,
):
    """Run the Triton kernel; returns ``(y, evals, rec, info)`` like the XLA
    engine (state rows padded to a power of two, sliced by the caller)."""
    if tile_b < 16 or tile_b & (tile_b - 1):
        raise ValueError(f"the Triton engine needs a power-of-two tile_b >= 16, got {tile_b}")
    f32 = jnp.float32
    k, n, _ = operators.shape
    n_pad = _pad_dim(n)
    B = y0.shape[1]
    L = B // tile_b
    n_env = amps.shape[1]
    n_eval = 0 if eval_ts is None else len(eval_ts)

    def pad_rows(x, axes):
        widths = [(0, 0)] * x.ndim
        for a in axes:
            widths[a] = (0, n_pad - n)
        return jnp.pad(x, widths)

    sr = pad_rows(jnp.real(static_op).astype(f32), (0, 1))
    si = pad_rows(jnp.imag(static_op).astype(f32), (0, 1))
    opr = pad_rows(jnp.real(operators).astype(f32), (1, 2))
    opi = pad_rows(jnp.imag(operators).astype(f32), (1, 2))
    w = pad_rows(jnp.stack([jnp.asarray(w_hi, f32), jnp.asarray(w_lo, f32)]), (1,))
    fr = jnp.stack([jnp.asarray(fr_hi, f32).reshape(k), jnp.asarray(fr_lo, f32).reshape(k)])
    inputs = [
        sr, si, opr, opi, w, fr,
        jnp.real(amps).astype(f32), jnp.imag(amps).astype(f32),
    ]
    if n_eval > 0:
        inputs.append(jnp.asarray(np.asarray(eval_ts, np.float32)))
    inputs += [pad_rows(jnp.real(y0).astype(f32), (0,)), pad_rows(jnp.imag(y0).astype(f32), (0,))]
    out_shape = [jax.ShapeDtypeStruct((n_pad, B), f32)] * 2
    if n_eval > 0:
        out_shape += [jax.ShapeDtypeStruct((n_eval, n_pad, B), f32)] * 2
    out_shape += [
        jax.ShapeDtypeStruct((L, max_steps), f32),
        jax.ShapeDtypeStruct((L, 3), jnp.int32),
    ]
    kernel = functools.partial(
        _triton_kernel, n, k, int(n_env), float(env_dt), split_const(float(t0)),
        split_const(float(tf) - float(t0)), float(atol), float(rtol),
        int(max_steps), float(h0), n_eval, int(tile_b),
    )
    outs = pl.pallas_call(
        kernel,
        grid=(L,),
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=_triton_warps(n_pad, tile_b), num_stages=1
        ),
        interpret=interpret,
        name="lockstep_dopri5",
    )(*inputs)
    y = jax.lax.complex(outs[0], outs[1])
    ev = jax.lax.complex(outs[2], outs[3]) if n_eval > 0 else None
    return y, ev, outs[-2], outs[-1]


# ---------------------------------------------------------------------------
# public entry


def _prepare(signal_amps, tf, t0, env_dt, eval_ts, tile_b, B):
    if B % tile_b != 0:
        raise ValueError(f"sweep batch {B} must be a multiple of tile_b={tile_b}")
    if signal_amps.ndim == 2:
        signal_amps = signal_amps[:, None, :]
        env_dt = float(tf - t0)  # any positive value; the cell is always 0
    elif env_dt <= 0.0:
        raise ValueError("env_dt must be set when passing (k, S, B) envelope tables.")
    if eval_ts is not None:
        ts = np.asarray(eval_ts, dtype=np.float64)
        if ts.ndim != 1 or ts.size == 0:
            raise ValueError("eval_ts must be a non-empty 1d tuple of times.")
        if np.any(ts <= 0) or np.any(ts > (tf - t0) * (1 + 1e-9)):
            raise ValueError("eval_ts must lie in (0, tf - t0].")
        if ts.size > 1 and np.any(np.diff(ts) <= 0):
            raise ValueError("eval_ts must be strictly increasing.")
        eval_ts = tuple(float(x) for x in ts)
    return signal_amps, float(env_dt), eval_ts


def _finish(raw, n, tile_b, record_steps, n_eval):
    """Slice padded rows, NaN-poison failed groups, zero unused step slots."""
    y, ev, rec, info = raw
    lane_ok = jnp.repeat(info[:, 0] > 0, tile_b)
    poison = jnp.where(lane_ok, 1.0, jnp.nan).astype(jnp.float32)
    y = y[:n] * poison
    result = y if n_eval == 0 else (y, ev[:, :n] * poison)
    if record_steps:
        used = jnp.arange(rec.shape[1])[None, :] < info[:, 2][:, None]
        return result, jnp.where(used, rec, 0.0)
    return result


def sweep_dopri5_lockstep_split(
    static_op, operators, omega_hi, omega_lo, freq_hi, freq_lo, signal_amps, y0,
    tf, t0=0.0, atol=1e-6, rtol=1e-6, max_steps=4096, h0=1e-2,
    tile_b=None, env_dt=0.0, eval_ts=None, record_steps=False,
    engine=None, interpret=False,
):
    """:func:`sweep_dopri5_lockstep` on pre-split (hi, lo) frequencies.

    ``engine`` ``None`` picks by :func:`lockstep_engine`; ``"xla"`` or
    ``"triton"`` name one (the tests compare the two)."""
    signal_amps = jnp.asarray(signal_amps)
    y0 = jnp.asarray(y0)
    tile_b = lockstep_tile_b(operators.shape[1]) if tile_b is None else int(tile_b)
    amps, env_dt, eval_ts = _prepare(
        signal_amps, tf, t0, env_dt, eval_ts, tile_b, y0.shape[-1]
    )
    # w[m] - w[0] = omega[0, m]: row 0 is a representative frame diagonal
    # (a constant shift is a global phase that cancels in D^-1 A D)
    w_hi, w_lo = jnp.asarray(omega_hi)[0], jnp.asarray(omega_lo)[0]
    engine = engine or lockstep_engine(interpret)
    statics = dict(
        tf=float(tf), t0=float(t0), atol=float(atol), rtol=float(rtol),
        max_steps=int(max_steps), h0=float(h0), tile_b=int(tile_b),
        env_dt=env_dt, eval_ts=eval_ts,
    )
    args = (static_op, operators, w_hi, w_lo, freq_hi, freq_lo, amps, y0)
    if engine == "triton":
        raw = _lockstep_triton(*args, interpret=bool(interpret), **statics)
    elif engine == "xla":
        raw = _lockstep_xla(*args, **statics)
    else:
        raise ValueError(f"unknown lockstep engine {engine!r}; use 'triton' or 'xla'.")
    n_eval = 0 if eval_ts is None else len(eval_ts)
    return _finish(raw, operators.shape[1], int(tile_b), record_steps, n_eval)


def sweep_dopri5_lockstep(
    static_op, operators, frame_omega, signal_freqs, signal_amps, y0,
    tf, t0=0.0, atol=1e-6, rtol=1e-6, max_steps=4096, h0=1e-2,
    tile_b=None, env_dt=0.0, eval_ts=None, record_steps=False,
    engine=None, interpret=False,
):
    r"""Lockstep-adaptive dopri5 sweep over ``[t0, tf]``.

    Args:
        static_op: (n, n) complex static generator (frame basis, diag removed).
        operators: (k, n, n) complex signal operators (frame basis).
        frame_omega: (n, n) real frame frequency-difference matrix
            (``omega[i, m] = w[m] - w[i]``).
        signal_freqs: (k,) real angular carrier frequencies (``2 pi nu_j``).
        signal_amps: per-member complex envelopes: (k, B) for constant
            envelopes (``c_j(t,b) = Re[A_jb e^{i w_j t}]``) or (k, S, B) for
            piecewise-constant envelopes sampled every ``env_dt``.
        y0: (n, B) complex initial states (frame basis).
        tf: final time; integration runs over [t0, tf]. Envelope tables
            cover [t0, tf] and are indexed by elapsed time.
        atol/rtol: tolerances (error controlled at the worst member per group).
        max_steps: step budget per group; exhausted -> NaN output.
        h0: initial step size.
        tile_b: lockstep group size (B must be a multiple; a power of two
            of at least 16 on the Triton engine); ``None`` picks
            :func:`lockstep_tile_b`.
        env_dt: envelope sample width (required when signal_amps is 3d).
        eval_ts: optional static tuple of ELAPSED trajectory times (relative
            to ``t0``), strictly increasing, each in ``(0, tf - t0]``: steps
            clip to these boundaries and the state at each is stored.
        record_steps: additionally return each group's accepted step sizes
            as an (n_groups, max_steps) f32 array (zero-padded) — the input
            to the AD replay (``ops/adaptive_replay.py``).
        engine: ``None`` (by platform, :func:`lockstep_engine`), ``"triton"``
            or ``"xla"``.
        interpret: run the Triton kernel in the Pallas interpreter (CPU tests).

    Returns:
        (n, B) complex final states (frame basis); with ``eval_ts``, a tuple
        ``(final, trajectory)`` where ``trajectory`` is (len(eval_ts), n, B).
        With ``record_steps``, the result is wrapped as ``(result, steps)``.
    """

    def _split(x):
        try:
            arr = np.asarray(x)
        except Exception:  # traced value — the f64 bits are already gone
            arr = jnp.asarray(x).astype(jnp.float32)
            return arr, jnp.zeros_like(arr)
        hi, lo = split_array(arr)
        return jnp.asarray(hi), jnp.asarray(lo)

    omega_hi, omega_lo = _split(frame_omega)
    freq_hi, freq_lo = _split(signal_freqs)
    return sweep_dopri5_lockstep_split(
        static_op, operators, omega_hi, omega_lo, freq_hi, freq_lo, signal_amps,
        y0, tf, t0=t0, atol=atol, rtol=rtol, max_steps=max_steps, h0=h0,
        tile_b=tile_b, env_dt=env_dt, eval_ts=eval_ts, record_steps=record_steps,
        engine=engine, interpret=interpret,
    )
