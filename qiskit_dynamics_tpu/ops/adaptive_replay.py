r"""Differentiable adaptive fused sweeps: lockstep primal, recorded-grid replay.

The lockstep-adaptive engines (:mod:`.adaptive_sweep`) carry no autodiff
rules — the Triton kernel has none, and a ``while_loop`` with a
data-dependent trip count cannot be reverse-differentiated anyway. The trick:
adaptivity only *chooses* the step grid — the solution is an ordinary
fixed-grid dopri5 integration OF THAT GRID. So:

- **forward**: run the lockstep engine with ``record_steps=True`` — it
  additionally returns each group's accepted step sizes (``(n_groups,
  max_steps)`` f32, zero-padded);
- **backward**: replay the recorded grid with :func:`dopri5_replay` — plain
  XLA ops, chunk-checkpointed ``lax.scan``, one ``lax.cond`` skip per step so
  the zero padding costs (almost) nothing — and pull the cotangent through
  ``jax.vjp`` of the replay. Step-size selection is treated as
  non-differentiable (the standard convention for adaptive solvers: gradients
  flow through the accepted states, not the controller).

The replay reproduces the primal's integration faithfully: identical dopri5
tableau, identical df32 time accumulation, the same right-hand side
(:func:`.adaptive_sweep.lockstep_rhs`, EFT-reduced phase arguments and the
frame as the diagonal conjugation ``G y = D^(-1) (A (D y))``), identical
envelope-cell selection at the step midpoint, identical trajectory-store
logic — so the replayed trajectory matches the primal to f32 roundoff and
the VJP is the exact adjoint of (that faithful copy of) the primal.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .rk_tableaus import (
    DOPRI5_A as _A,
    DOPRI5_B as _B,
    DOPRI5_C as _C,
    DOPRI5_N_STAGES as _N_STAGES,
)
from .adaptive_sweep import lockstep_rhs, sweep_dopri5_lockstep_split
from .trig_reduce import split_const, time_add

__all__ = ["dopri5_replay", "sweep_dopri5_lockstep_ad"]

_CHUNK = 64  # steps per checkpointed scan chunk


def dopri5_replay(
    static_op,
    operators,
    omega_hi,
    omega_lo,
    freq_hi,
    freq_lo,
    signal_amps,
    y0,
    h_rec,
    t0: float,
    env_dt: float,
    eval_ts=None,
):
    r"""Fixed-grid dopri5 integration of a recorded lockstep step sequence.

    Args mirror :func:`.adaptive_sweep.sweep_dopri5_lockstep` (inputs already
    f32-split and with ``signal_amps`` in (k, n_env, B) complex layout);
    ``h_rec`` is the (n_groups, max_steps) accepted-step record (zero-padded).
    Returns the (n, B) final state, or ``(final, (n_eval, n, B) trajectory)``
    with ``eval_ts``.
    """
    f32 = jnp.float32
    c64 = jnp.complex64
    static = jnp.asarray(static_op).astype(c64)
    ops = jnp.asarray(operators).astype(c64)
    k, n, _ = ops.shape
    amps = jnp.asarray(signal_amps).astype(c64)  # (k, n_env, B)
    n_env = amps.shape[1]
    y0 = jnp.asarray(y0).astype(c64)
    B = y0.shape[1]
    h_rec = jnp.asarray(h_rec).astype(f32)
    n_tiles, max_steps = h_rec.shape
    tile_b = B // n_tiles

    # w[m] - w[i] = omega[i, m]: any representative w with those differences
    # works (a constant shift is a global phase that cancels in D A D^-1);
    # row 0 of the (hi, lo) split is itself a valid df split of that choice
    w_hi = jnp.asarray(omega_hi).astype(f32)[0]  # (n,)
    w_lo = jnp.asarray(omega_lo).astype(f32)[0]
    fr_hi = jnp.asarray(freq_hi).astype(f32).reshape(k)
    fr_lo = jnp.asarray(freq_lo).astype(f32).reshape(k)
    inv_env_dt = 1.0 / env_dt if env_dt > 0 else 0.0

    # lanes -> (L, tile_b) tile-major
    y = jnp.moveaxis(y0, 0, -1).reshape(n_tiles, tile_b, n)  # (L, Bt, n)
    amps_t = amps.reshape(k, n_env, n_tiles, tile_b)

    n_eval = 0
    targets = None
    if eval_ts is not None:
        ts = np.asarray(eval_ts, dtype=np.float32)
        n_eval = ts.size
        targets = jnp.asarray(ts)

    rhs = lockstep_rhs(
        static, ops, (w_hi, w_lo), (fr_hi, fr_lo), split_const(float(t0)), amps_t
    )

    def one_step(carry, h):
        """One recorded (possibly zero-length) dopri5 step; h: (L,)."""
        y_c, s_hi, s_lo, eidx, evals = carry
        active = h > 0

        def do_step(args):
            y_c, s_hi, s_lo, eidx, evals = args
            s_pair = (s_hi, s_lo)
            if n_env > 1:
                cell = jnp.clip(
                    ((s_hi + 0.5 * h) * inv_env_dt).astype(jnp.int32), 0, n_env - 1
                )
            else:
                cell = jnp.zeros_like(s_hi, dtype=jnp.int32)
            hb = h[:, None, None]
            ks = [rhs(y_c, s_pair, cell)]
            for s in range(1, _N_STAGES):
                incr = sum(
                    float(_A[s, q]) * ks[q] for q in range(s) if _A[s, q] != 0.0
                )
                st = time_add(s_pair, jnp.float32(_C[s]) * h)
                ks.append(rhs(y_c + hb * incr, st, cell))
            y_new = y_c + hb * sum(
                float(_B[s]) * ks[s] for s in range(_N_STAGES) if _B[s] != 0.0
            )
            sn_hi, sn_lo = time_add(s_pair, h)
            s_hi2 = jnp.where(active, sn_hi, s_hi)
            s_lo2 = jnp.where(active, sn_lo, s_lo)
            y2 = jnp.where(active[:, None, None], y_new, y_c)
            if n_eval > 0:
                tgt = targets[jnp.clip(eidx, 0, n_eval - 1)]
                eps = (4.0 * 1.1920929e-7) * jnp.maximum(1.0, tgt)
                reached = active & (eidx < n_eval) & (s_hi2 >= tgt - eps)
                onehot = (
                    (jnp.arange(n_eval)[:, None] == eidx[None, :]) & reached[None, :]
                )  # (n_eval, L)
                evals = jnp.where(onehot[:, :, None, None], y2[None], evals)
                eidx = eidx + reached.astype(jnp.int32)
            return y2, s_hi2, s_lo2, eidx, evals

        out = jax.lax.cond(
            jnp.any(active), do_step, lambda a: a, (y_c, s_hi, s_lo, eidx, evals)
        )
        return out, None

    def chunk_fn(carry, h_chunk):
        """A _CHUNK-step block (checkpointed: only block boundaries stored)."""
        carry, _ = jax.lax.scan(one_step, carry, h_chunk)
        return carry, None

    pad = (-max_steps) % _CHUNK
    h_seq = jnp.moveaxis(h_rec, 0, 1)  # (max_steps, L)
    if pad:
        h_seq = jnp.concatenate([h_seq, jnp.zeros((pad, n_tiles), f32)])
    h_chunks = h_seq.reshape(-1, _CHUNK, n_tiles)

    evals0 = (
        jnp.zeros((n_eval, n_tiles, tile_b, n), c64) if n_eval > 0 else jnp.zeros(())
    )
    carry0 = (
        y,
        jnp.zeros(n_tiles, f32),
        jnp.zeros(n_tiles, f32),
        jnp.zeros(n_tiles, jnp.int32),
        evals0,
    )
    (y_f, _, _, _, evals_f), _ = jax.lax.scan(
        jax.checkpoint(chunk_fn), carry0, h_chunks
    )

    final = jnp.moveaxis(y_f.reshape(B, n), 0, 1)  # (n, B)
    if n_eval > 0:
        traj = jnp.moveaxis(evals_f.reshape(n_eval, B, n), 1, 2)  # (n_eval, n, B)
        return final, traj
    return final


def _ad_statics(tf, t0, atol, rtol, max_steps, h0, tile_b, env_dt, eval_ts, interpret):
    return dict(
        tf=tf, t0=t0, atol=atol, rtol=rtol, max_steps=max_steps, h0=h0,
        tile_b=tile_b, env_dt=env_dt, eval_ts=eval_ts, interpret=interpret,
    )


@functools.partial(
    jax.custom_vjp, nondiff_argnums=(8, 9, 10, 11, 12, 13, 14, 15, 16, 17)
)
def sweep_dopri5_lockstep_ad(
    static_op, operators, omega_hi, omega_lo, freq_hi, freq_lo, signal_amps,
    y0,
    tf, t0, atol, rtol, max_steps, h0, tile_b, env_dt, eval_ts, interpret,
):
    """Differentiable lockstep-adaptive sweep: lockstep primal, recorded-grid
    XLA replay adjoint (see the module docstring). Array arguments must be
    pre-split (the glue holds the host f64 values); statics are positional
    for ``custom_vjp``. Returns what the engine returns (final state, plus
    trajectory with ``eval_ts``)."""
    return sweep_dopri5_lockstep_split(
        static_op, operators, omega_hi, omega_lo, freq_hi, freq_lo,
        signal_amps, y0, **_ad_statics(
            tf, t0, atol, rtol, max_steps, h0, tile_b, env_dt, eval_ts, interpret
        ),
    )


def _ad_fwd(
    static_op, operators, omega_hi, omega_lo, freq_hi, freq_lo, signal_amps,
    y0,
    tf, t0, atol, rtol, max_steps, h0, tile_b, env_dt, eval_ts, interpret,
):
    out, rec = sweep_dopri5_lockstep_split(
        static_op, operators, omega_hi, omega_lo, freq_hi, freq_lo,
        signal_amps, y0, record_steps=True, **_ad_statics(
            tf, t0, atol, rtol, max_steps, h0, tile_b, env_dt, eval_ts, interpret
        ),
    )
    residuals = (
        static_op, operators, omega_hi, omega_lo, freq_hi, freq_lo,
        signal_amps, y0, jax.lax.stop_gradient(rec),
    )
    return out, residuals


def _ad_bwd(
    tf, t0, atol, rtol, max_steps, h0, tile_b, env_dt, eval_ts, interpret,
    residuals, cotangent,
):
    (
        static_op, operators, omega_hi, omega_lo, freq_hi, freq_lo,
        signal_amps, y0, rec,
    ) = residuals
    # the engines need env_dt > 0 only in table mode; replay mirrors that
    eff_env_dt = env_dt if env_dt > 0 else float(tf) - float(t0)

    def f(static_op, operators, omega_hi, omega_lo, freq_hi, freq_lo,
          signal_amps, y0):
        amps = signal_amps
        if amps.ndim == 2:
            amps = amps[:, None, :]
        return dopri5_replay(
            static_op, operators, omega_hi, omega_lo, freq_hi, freq_lo,
            amps, y0, rec, t0=t0, env_dt=eff_env_dt, eval_ts=eval_ts,
        )

    _, vjp = jax.vjp(
        f, static_op, operators, omega_hi, omega_lo, freq_hi, freq_lo,
        signal_amps, y0,
    )
    return vjp(cotangent)


sweep_dopri5_lockstep_ad.defvjp(_ad_fwd, _ad_bwd)
