r"""Generic fused-sweep solver API.

Given a Hamiltonian/generator model and a parameterized signal constructor,
:func:`fused_sweep_solve` runs a fixed-step Magnus solve for a whole
parameter batch as one device program (``ops/xla_sweep.py``: batched
generators, the Magnus commutator rule and a Horner Taylor ``expm`` action
under one ``lax.scan``), and :func:`fused_adaptive_sweep_solve` runs a
lockstep-adaptive dopri5 sweep (``ops/adaptive_sweep.py``).

Restrictions (by construction of the engines):
- dense ``GeneratorModel``/``HamiltonianModel`` or vectorized ``LindbladModel``;
- all sweep members share ``y0`` and the time grid;
- signal values must be real (standard ``Re[f e^{i 2 pi nu t}]`` signals).

Engines: the batch-major XLA engine serves ``solve_dim <= 128``; larger
problems (vectorized Lindblad reaches ``dim^2`` fast) route to the
polynomial-expanded engine (``ops/polynomial_sweep.py``) with the same step
rule — see the ``sweep_engine`` argument.

Precision: ``precision="f32"`` (default) runs in float32 (~1e-6 accuracy
floor); ``precision="df32"`` runs the compensated double-float32 engine
(``ops/df_sweep.py``) for 1e-8-class agreement with float64 references.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..exceptions import DynamicsError
from ..models import LindbladModel
from ..models.operator_collections import OperatorCollection, VectorizedLindbladCollection
from ..signals import SignalList
from ..ops.xla_sweep import (
    _GAUSS3_D1,
    _GAUSS3_D2,
    _GAUSS3_D3,
    _GAUSS_C1,
    _GAUSS_C2,
    _P2,
    split_omega_host,
    sweep_expm_magnus2_xla,
)
from ..ops.adaptive_replay import sweep_dopri5_lockstep_ad
from ..ops.adaptive_sweep import lockstep_tile_b, sweep_dopri5_lockstep_split
from ..ops.trig_reduce import split_array
from .fixed_step_solvers import get_fixed_step_sizes

__all__ = ["fused_sweep_solve", "fused_adaptive_sweep_solve"]


def _extract_generator_data(model, t_span, fn_name: str):
    """Shared validation + frame-basis data extraction for the fused solvers.

    Returns ``(vectorized_lindblad, solve_dim, static_fb, ops_fb, omega, t0, tf)``.
    """
    vectorized_lindblad = isinstance(model, LindbladModel)
    if vectorized_lindblad and not model.vectorized:
        raise DynamicsError(f"{fn_name} supports LindbladModel only with vectorized=True.")
    coll = model._operator_collection
    if vectorized_lindblad:
        if not isinstance(coll, VectorizedLindbladCollection) or not isinstance(
            coll._operator_collection, OperatorCollection
        ):
            raise DynamicsError(f"{fn_name} requires a dense vectorized collection.")
        inner = coll._operator_collection
    else:
        if (
            coll.operators is None
            or getattr(coll, "_sparse", False)
            or not isinstance(coll, OperatorCollection)
        ):
            raise DynamicsError(f"{fn_name} requires dense operators.")
        inner = coll

    t0, tf = float(t_span[0]), float(t_span[-1])
    if tf <= t0:
        raise DynamicsError(f"{fn_name} requires t_span[1] > t_span[0].")

    solve_dim = model.dim**2 if vectorized_lindblad else model.dim
    static_fb = inner.static_operator
    if static_fb is None:
        static_fb = np.zeros(2 * (solve_dim,), dtype=complex)
    static_fb = np.asarray(static_fb)
    ops_fb = np.asarray(inner.operators)

    frame_diag = model.rotating_frame.frame_diag
    if frame_diag is None:
        omega = np.zeros(2 * (solve_dim,))
    else:
        w = np.imag(np.asarray(frame_diag))
        if vectorized_lindblad:
            # column-stacking vec: index a = col*n + row; phase of vec index
            # a is w_row - w_col (see vec_commutator conventions)
            w = (w[None, :] - w[:, None]).ravel()
        omega = w[None, :] - w[:, None]

    return vectorized_lindblad, solve_dim, static_fb, ops_fb, omega, t0, tf


def _all_anti_hermitian(static_fb, ops_fb) -> bool:
    """Host check: every generator matrix is anti-Hermitian (``G = -iH``).

    True for Hamiltonian dynamics (real signal coefficients keep any linear
    combination anti-Hermitian, and the elementwise frame rotation preserves
    it since ``omega`` is antisymmetric) — enables the one-matmul Magnus
    commutator in the engines.
    """
    for a in (np.asarray(static_fb),) + tuple(np.asarray(ops_fb)):
        scale = max(1.0, float(np.max(np.abs(a))))
        if not np.allclose(a, -a.conj().T, rtol=0.0, atol=1e-12 * scale):
            return False
    return True


def fused_sweep_solve(
    model,
    signals_fn: Callable,
    params,
    t_span,
    max_dt: float,
    y0,
    expm_order: int = 8,
    rwa_signal_map: Optional[Callable] = None,
    precision: str = "f32",
    df_chunk_b: int = 2048,
    df_magnus_order: int = 3,
    df_grid: str = "uniform",
    df_grid_tol: float = 1e-9,
    df_fast: bool = True,
    df_horner_tail: int = 6,
    df_devices=None,
    sweep_engine: str = "auto",
    magnus_order: int = 2,
    t_eval=None,
    mesh=None,
):
    r"""Solve ``y' = G_b(t) y`` for a parameter sweep as one device program.

    Args:
        model: a dense ``GeneratorModel``/``HamiltonianModel``, or a
            ``LindbladModel`` with ``vectorized=True`` (then ``y0`` is a
            density matrix and ``signals_fn`` returns a
            ``(hamiltonian_signals, dissipator_signals)`` tuple).
        signals_fn: maps one parameter pytree -> signal list for the model's
            operators (jax-traceable in the parameters).
        params: batched parameters (dim 0 = sweep axis).
        t_span: ``(t0, tf)``; the grid is ``ceil((tf-t0)/max_dt)`` equal steps.
        max_dt: maximum step size.
        y0: shared initial state, shape (dim,).
        expm_order: Taylor order of the per-step ``expm`` action.
        rwa_signal_map: optional signal map (as returned by
            ``rotating_wave_approximation``) applied to ``signals_fn``'s
            output. If the model was RWA'd (e.g. built through ``Solver`` with
            ``rwa_cutoff_freq``), this MUST be passed explicitly (e.g.
            ``solver._rwa_signal_map``) — there is no automatic wiring.
        precision: ``"f32"`` (~1e-6 floor) or ``"df32"``
            (compensated double-float32 engine, ~1e-8-class accuracy; see
            ``ops/df_sweep.py``). The df32 path is host-facing: ``params``
            must be concrete (not traced) — signals are sampled in float64 on
            host — and the result is a host complex128 array.
        df_chunk_b: (df32 only) sweep members per device dispatch.
        df_magnus_order: (df32 only) 2 (4th-order step rule) or 3 (6th-order,
            default — much larger steps at 1e-8 accuracy).
        df_grid: (df32 only) ``"uniform"`` (``max_dt``-sized equal steps, the
            default) or ``"adaptive"`` — a host-f64 step-doubling walk of
            probe members builds a non-uniform grid that concentrates steps
            where the generator varies (see ``_adaptive_df_grid``); ``max_dt``
            is then ignored in favor of ``df_grid_tol``.
        df_grid_tol: (df32, adaptive grid) target total truncation error of
            the grid walk.
        df_fast: (df32 only) evaluate the Magnus commutators in plain
            complex64 (they are O(dt^2)-relative corrections) — ~3x faster at
            ~1e-10-class extra error; disable for the full-df engine.
        df_horner_tail: (df32 only) expm Horner iterations above this index
            run in complex64 (damped by ``|M|^j/j!``); 0 = full df.
        df_devices: (df32 only) optional list of ``jax.Device`` — sweep
            chunks dispatch round-robin across them (host-fed data
            parallelism; e.g. ``jax.devices()``). The engine is
            host-orchestrated, so this — not ``mesh=`` — is its multi-device
            path.
        t_eval: optional strictly-increasing trajectory times. When given,
            the return value is the full trajectory ``(B, len(t_eval), ...)``
            instead of final states only — stored inside the scan at the
            marked steps and differentiable. On the ``"f32"`` path each time
            must lie on the fixed step grid ``t0 + j dt`` (the engines take
            one scalar ``dt``; off-grid points raise). With
            ``precision="df32"`` ARBITRARY times are accepted: the engine
            takes per-step sizes, so an off-grid point
            splits the containing step at exactly that time (truncation
            error can only shrink; see ``_df_eval_slots``).
        sweep_engine: ``"xla"`` (batch-major matmuls under one
            ``lax.scan``), ``"poly"`` (polynomial-expanded Magnus: the frame
            mask is a diagonal conjugation, so the whole bracket rule
            expands host-side into ~tens of member-independent matrices and
            each step costs ONE ``(B, Q) @ (Q, n^2)`` matmul instead of
            per-member batched commutator matmuls — the large-dim path; see
            :mod:`~qiskit_dynamics_tpu.ops.polynomial_sweep`), or ``"auto"``
            (default): xla up to ``solve_dim`` 128, poly above. Identical
            Magnus rule and Taylor polynomial on both engines.
        magnus_order: commutator truncation of the per-step Magnus rule —
            ``2`` (2-point Gauss, 4th order, default) or ``3`` (3-point
            Gauss, 6th order). Order 3 admits ~2.5-3x larger ``max_dt`` at
            equal accuracy — the lever for long fixed-step sweeps.
        mesh: optional ``jax.sharding.Mesh`` — shard the sweep batch over the
            mesh's ``"data"`` axis (``parallel.pshard_batch``): each device
            runs the engine on its shard of ``params``, SPMD with no
            collectives on the solve path. Batches pad to a multiple of the
            axis size (trimmed on return). ``precision="f32"`` only.

    Returns:
        (B, dim) final states at ``tf`` (standard basis, in-frame values
        rotated out of the frame basis). complex64-class device array for
        ``"f32"``; complex128 host array for ``"df32"``.
    """
    if precision not in ("f32", "df32"):
        raise DynamicsError(f"unknown precision {precision!r}; use 'f32' or 'df32'.")
    if mesh is not None:
        # multi-device: shard the sweep batch over the mesh's data axis —
        # each device runs the engine on its shard (SPMD; no collectives on
        # the solve path). The df32 engine orchestrates host-side chunking
        # and cannot run under shard_map's tracer.
        if precision == "df32":
            raise DynamicsError(
                'fused_sweep_solve(mesh=...) supports precision="f32" only; '
                "the df32 engine is host-orchestrated — pass "
                "df_devices=jax.devices() for round-robin multi-device df32."
            )
        from ..parallel.sweep import pshard_batch

        def _local(p):
            return fused_sweep_solve(
                model, signals_fn, p, t_span=t_span, max_dt=max_dt, y0=y0,
                expm_order=expm_order, rwa_signal_map=rwa_signal_map,
                precision=precision, sweep_engine=sweep_engine,
                magnus_order=magnus_order, t_eval=t_eval, mesh=None,
            )

        return pshard_batch(_local, mesh=mesh)(params)
    if magnus_order not in (2, 3):
        raise DynamicsError(
            f"magnus_order must be 2 or 3, got {magnus_order!r}."
        )
    (
        vectorized_lindblad,
        solve_dim,
        static_fb,
        ops_fb,
        omega,
        t0,
        tf,
    ) = _extract_generator_data(model, t_span, "fused_sweep_solve")

    # same step-grid rule as the generic fixed-step solvers, so results match
    # method="jax_expm" exactly
    _, h_list, n_steps_list = get_fixed_step_sizes((t0, tf), None, max_dt)
    n_steps = int(n_steps_list[0])
    dt = float(h_list[0])
    if magnus_order == 2:
        gauss_nodes = np.array([_GAUSS_C1, _GAUSS_C2])
    else:
        gauss_nodes = np.array([_GAUSS3_D1, _GAUSS3_D2, _GAUSS3_D3])
    gauss_times = t0 + dt * (np.arange(n_steps)[:, None] + gauss_nodes[None, :])

    k = ops_fb.shape[0]

    def signals_as_list(p) -> SignalList:
        sigs = signals_fn(p)
        if isinstance(sigs, tuple):
            # Lindblad convention: (hamiltonian_signals, dissipator_signals)
            if rwa_signal_map is not None:
                sigs = rwa_signal_map(sigs)
            ham_sigs, dis_sigs = sigs
            sigs = list(ham_sigs) + list(dis_sigs or [])
        else:
            if rwa_signal_map is not None:
                sigs = rwa_signal_map(sigs)
        if not isinstance(sigs, SignalList):
            sigs = SignalList(list(sigs))
        if len(sigs) != k:
            raise DynamicsError(
                f"signals_fn (after any rwa_signal_map) must produce {k} signals to "
                f"match the model's operators; got {len(sigs)}."
            )
        return sigs

    if vectorized_lindblad:
        rho_fb = np.asarray(model.rotating_frame.operator_into_frame_basis(np.asarray(y0)))
        y0_fb = rho_fb.ravel(order="F")  # column-stacking vec
    else:
        y0_fb = np.asarray(model.rotating_frame.state_into_frame_basis(np.asarray(y0)))

    if precision == "df32":
        if df_grid == "adaptive":
            dts = _adaptive_df_grid(
                signals_as_list, params, static_fb, ops_fb, omega, t0, tf,
                df_magnus_order, df_grid_tol,
            )
        elif df_grid == "uniform":
            dts = np.full(n_steps, dt)
        else:
            raise DynamicsError(
                f"unknown df_grid {df_grid!r}; use 'uniform' or 'adaptive'."
            )
        dts, df_eval_slots, df_include_t0 = _df_eval_slots(t_eval, dts, t0, tf)
        return _fused_sweep_solve_df(
            model, signals_as_list, params, dts, static_fb, ops_fb, omega,
            y0_fb, vectorized_lindblad, t0, expm_order, df_chunk_b,
            df_magnus_order, fast_commutators=df_fast,
            horner_df_tail=df_horner_tail, devices=df_devices,
            eval_slots=df_eval_slots, include_t0=df_include_t0,
        )

    eval_slots = None
    include_t0 = False
    if t_eval is not None:
        te = np.atleast_1d(np.asarray(t_eval, dtype=float))
        if te.ndim != 1 or te.size == 0:
            raise DynamicsError("t_eval must be a non-empty 1d sequence of times.")
        if te.size > 1 and np.any(np.diff(te) <= 0):
            raise DynamicsError("t_eval must be strictly increasing.")
        if te[0] < t0 - 1e-9 or te[-1] > tf + 1e-9 * max(1.0, abs(tf)):
            raise DynamicsError(f"t_eval must lie within t_span ({t0}, {tf}).")
        s = (te - t0) / dt
        s_round = np.round(s).astype(int)
        if np.any(np.abs(s - s_round) > 1e-6 * np.maximum(1.0, np.abs(s))):
            raise DynamicsError(
                "t_eval points must lie on the fixed step grid t0 + j*dt "
                f"(dt={dt}); off-grid trajectory output is not supported by "
                "the fused sweep — use the generic solvers for dense output."
            )
        if len(np.unique(s_round)) != len(s_round):
            # two "increasing" times rounding to one grid step would orphan
            # a trajectory slot (it would never be written)
            raise DynamicsError(
                "t_eval contains points that map to the same fixed step "
                f"(dt={dt}); remove the duplicates."
            )
        include_t0 = s_round[0] == 0
        kept_steps = s_round[1:] if include_t0 else s_round
        slots = np.full(n_steps, -1, dtype=int)
        for j, st in enumerate(kept_steps):
            slots[st - 1] = j
        eval_slots = tuple(int(x) for x in slots) if len(kept_steps) else None

    if sweep_engine == "auto":
        sweep_engine = _auto_sweep_engine(solve_dim)
    if sweep_engine not in ("xla", "poly"):
        raise DynamicsError(
            f"unknown sweep_engine {sweep_engine!r}; use 'xla', 'poly' or 'auto'."
        )
    coeffs = jnp.moveaxis(
        jax.vmap(lambda p: signals_as_list(p)(jnp.asarray(gauss_times)))(params), 0, -1
    )  # (T, n_gauss, k, B)
    # batch-major (B, n, m): the engine builds each member's O(n^3)
    # generators/commutator ONCE and applies them to all m state columns
    B = coeffs.shape[-1]
    y0_mat = np.asarray(y0_fb).reshape(solve_dim, -1)
    m = y0_mat.shape[1]
    y0_bm = jnp.broadcast_to(jnp.asarray(y0_mat)[None], (B, solve_dim, m))
    if sweep_engine == "poly":
        from ..ops.polynomial_sweep import sweep_expm_magnus_poly

        # the frame diagonal (gauge d_0 = 0) recovered exactly from the
        # omega difference matrix — the expansion is gauge-invariant
        # (constant shifts of d cancel in every diagonal sandwich)
        d_im = np.asarray(omega, dtype=np.float64)[:, 0]
        out = sweep_expm_magnus_poly(
            static_fb, ops_fb, 1j * d_im, coeffs, y0_bm, dt=dt, t0=t0,
            order=expm_order, eval_slots=eval_slots, magnus_order=magnus_order,
        )
    else:
        omega_hi, omega_lo = split_omega_host(omega)
        out = sweep_expm_magnus2_xla(
            static_fb, ops_fb, omega_hi, coeffs, y0_bm, dt=dt, t0=t0,
            order=expm_order, hermitian=_all_anti_hermitian(static_fb, ops_fb),
            eval_slots=eval_slots, frame_omega_lo=omega_lo,
            magnus_order=magnus_order,
        )
    out_final, traj_bm = out if eval_slots is not None else (out, None)
    # back to the member-major column layout the collectors expect
    yf = jnp.moveaxis(out_final, 0, 1).reshape(solve_dim, B * m)
    traj = (
        jnp.transpose(traj_bm, (0, 2, 1, 3)).reshape(-1, solve_dim, B * m)
        if traj_bm is not None
        else None
    )
    y0_cols = (
        jnp.broadcast_to(jnp.asarray(y0_mat[:, 0])[:, None], (solve_dim, B))
        if m == 1
        else jnp.tile(jnp.asarray(y0_mat), (1, B))
    )

    if t_eval is not None:
        pieces = []
        if include_t0:
            pieces.append(jnp.asarray(y0_cols, dtype=yf.dtype)[None])
        if traj is not None:
            pieces.append(traj)
        traj = pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, axis=0)
        return _collect_trajectory(model, traj, B, m, vectorized_lindblad)

    if vectorized_lindblad:
        n = model.dim
        rho = jnp.transpose(yf[:, :B].reshape(n, n, B), (2, 1, 0))  # (B, n, n)
        return model.rotating_frame.operator_out_of_frame_basis(rho)
    return _collect_lanes(model, yf, B, m)


def _auto_sweep_engine(solve_dim: int) -> str:
    """Fixed-step engine for ``sweep_engine="auto"``: the polynomial-expanded
    engine once batched n^3 commutator matmuls dominate (``solve_dim > 128``);
    below that its f32 monomial-contraction rounding accumulates ~2x worse
    over many steps, so the batch-major xla engine keeps small dims."""
    return "poly" if solve_dim > 128 else "xla"


def _collect_trajectory(model, traj, B: int, m: int, vectorized_lindblad: bool):
    """(n_eval, dim, lanes) frame-basis trajectory -> user-facing layout:
    (B, n_eval, dim) / (B, n_eval, dim, m) / (B, n_eval, n, n) (Lindblad)."""
    if vectorized_lindblad:
        n = model.dim
        rho = jnp.transpose(traj[:, :, :B].reshape(-1, n, n, B), (3, 0, 2, 1))
        return model.rotating_frame.operator_out_of_frame_basis(rho)
    traj = traj[:, :, : B * m]
    traj = model.rotating_frame.state_out_of_frame_basis(traj)
    if m == 1:
        return jnp.transpose(traj, (2, 0, 1))  # (B, n_eval, dim)
    n_eval, dim = traj.shape[0], traj.shape[1]
    return jnp.moveaxis(traj.reshape(n_eval, dim, B, m), 2, 0)  # (B, n_eval, dim, m)


def _to_member_by_term(x, B: int, r: int):
    """Normalize a batched-signal attribute to (B, r), or ``None``.

    Scalars/(1,) broadcast; (B,) is one value per member (r == 1); (r,) is
    member-independent multi-term; (B, r) is the general batched SignalSum;
    (r, B) is the term-major layout RWA SignalSums produce for per-member
    phases. (B,) == (r,) and (B, r) == (r, B) coincidences with r > 1 and
    B == r are ambiguous -> ``None`` (caller falls back to full sampling).
    """
    x = np.atleast_1d(x)
    if x.ndim == 1 and x.size == 1:
        return np.broadcast_to(x.reshape(1, 1), (B, r))
    if x.ndim == 1 and r == 1 and x.shape[0] == B:
        return x[:, None]
    if x.ndim == 1 and x.shape[0] == r and B != r:
        return np.broadcast_to(x[None, :], (B, r))
    if x.ndim == 2 and x.shape == (B, r) and B != r:
        return x
    if x.ndim == 2 and x.shape == (r, B) and B != r:
        return x.T
    if x.ndim == 2 and x.shape == (B, r):  # B == r: ambiguous only if != .T
        return x if np.array_equal(x, x.T) else None
    return None


def _spread_probe_ts(all_ts, n_probe: int):
    """Up to ``n_probe`` spread-out times from a flat time grid."""
    all_ts = np.asarray(all_ts, dtype=float).ravel()
    idx = np.unique(
        np.round(np.linspace(0, len(all_ts) - 1, min(n_probe, len(all_ts)))).astype(int)
    )
    return all_ts[idx]


def _constant_envelope_factors(signals_as_list, params, all_ts, k, B):
    """Factorize a constant-envelope sweep as ``(A, carriers)``, or ``None``.

    When every signal's envelope is time-independent, the coefficient table
    ``c_j(t, b) = Re[sum_r A[j,r,b] e^{i 2 pi carriers[j,r] t}]`` factorizes
    into member amplitudes A (k, R, B) and member-INDEPENDENT carriers
    (k, R) — the df32 engine then assembles the (T, n_nodes, k, B) table on
    device (``coef_factors=``) instead of shipping it over the host link.

    Detection: every member's envelope is batch-probed at 8 spread-out Gauss
    times, then the LARGEST-amplitude member's envelope is densely scanned
    (up to 64 times) — a schedule that idles at all coarse probes but pulses
    between them (echo sequences) is caught by the dense scan instead of
    being silently factorized as constant-zero drive.

    Requires ``signals_fn`` to vectorize over the member axis (one batched
    signal construction; the common amplitude-sweep pattern). Returns
    ``None`` — caller falls back to full-table sampling — when construction
    or envelope evaluation fails, envelopes are time-dependent, or carriers
    are per-member.
    """
    if k == 0:
        return None  # no time-dependent terms: sampling path handles k=0
    probe_ts = _spread_probe_ts(all_ts, 8)
    try:
        sigs = list(signals_as_list(params))
    except Exception:
        return None
    amp_list, car_list = [], []
    for s in sigs:
        try:
            carriers = np.asarray(s.carrier_freq, dtype=float)
            phases = np.asarray(s.phase, dtype=float)
            envs = [np.asarray(s.envelope(t)) for t in probe_ts]
        except Exception:
            return None
        if carriers.ndim > 1:
            return None  # per-member carriers: no shared time factor
        envs = [np.asarray(e, dtype=complex) for e in envs]
        if not all(
            e.shape == envs[0].shape
            and np.allclose(e, envs[0], rtol=1e-14, atol=1e-14)
            for e in envs[1:]
        ):
            return None  # time-dependent envelope
        env = envs[0]
        carriers = np.atleast_1d(carriers)
        r = carriers.size

        env_b = _to_member_by_term(env, B, r)
        phase_b = _to_member_by_term(np.asarray(phases, dtype=float), B, r)
        if env_b is None or phase_b is None:
            return None
        amp_list.append(env_b * np.exp(1j * phase_b))
        car_list.append(carriers)

    # dense scan of the largest-amplitude member (single-member
    # construction, up to 64 times): catches envelopes that are zero (or
    # coincidentally equal) at every coarse probe but structured between
    # them. Probing can't be exhaustive; 8 spread + 64 dense on the loudest
    # member is the detection contract (documented in fused_sweep_solve).
    dense_ts = _spread_probe_ts(all_ts, 64)
    if len(dense_ts) > len(probe_ts):
        bstar = int(
            np.argmax(sum(np.abs(a).sum(axis=1) for a in amp_list))
        )
        try:
            ref_sigs = list(
                signals_as_list(
                    jax.tree_util.tree_map(lambda x: np.asarray(x)[bstar], params)
                )
            )
            for j, s_ref in enumerate(ref_sigs):
                r = car_list[j].shape[0]
                ref_amp = amp_list[j][bstar]  # (r,) complex
                ph_ref = np.broadcast_to(
                    np.atleast_1d(np.asarray(s_ref.phase, dtype=float)), (r,)
                )
                e_traj = _sample_envelope_trajectory(s_ref, dense_ts, r)
                if not np.allclose(
                    e_traj * np.exp(1j * ph_ref)[None, :],
                    ref_amp[None, :],
                    rtol=1e-12,
                    atol=1e-13,
                ):
                    return None  # time structure between coarse probes
        except Exception:
            return None
    r_max = max(a.shape[1] for a in amp_list)
    A = np.zeros((k, r_max, B), dtype=np.complex128)
    carr = np.zeros((k, r_max), dtype=np.float64)
    for j, (a, c) in enumerate(zip(amp_list, car_list)):
        A[j, : a.shape[1]] = a.T
        carr[j, : c.shape[0]] = c
    return A, carr


def _sample_envelope_trajectory(s, flat_ts, r: int):
    """A single signal's envelope at every time in ``flat_ts``, as (TN, r).

    Tries ONE vectorized ``envelope(flat_ts)`` call first (the signal
    machinery broadcasts time arrays; ~TN times cheaper than per-scalar
    dispatch) and falls back to the scalar loop for envelopes that don't
    broadcast.
    """
    tn = len(flat_ts)
    try:
        e = np.asarray(s.envelope(np.asarray(flat_ts)), dtype=complex)
        if e.shape == (tn,) and r == 1:
            return e[:, None]
        if e.shape == (tn, r):
            return e
        if e.shape == (r, tn) and r != tn:
            return e.T
        if e.ndim == 0 or e.shape in ((1,), (r,)):
            return np.broadcast_to(np.atleast_1d(e)[None, :], (tn, r)).copy()
    except Exception:
        pass
    return np.stack(
        [
            np.broadcast_to(np.atleast_1d(np.asarray(s.envelope(t), dtype=complex)), (r,))
            for t in flat_ts
        ],
        axis=0,
    )


def _rank1_envelope_factors(signals_as_list, params, gauss_times, k, B):
    """Factorize a fixed-shape, member-scaled sweep, or return ``None``.

    The amplitude-calibration pattern with a TIME-VARYING pulse shape: every
    member's signal is a complex scale of one shared shape,
    ``c_j(t, b) = Re[sum_r A_jrb P_jr(t)]`` with ``P_jr(t) = E_jr(t, b*)
    e^{i phi_jr(b*)} e^{i 2 pi nu_jr t}`` sampled host-f64 from a reference
    member ``b*`` — the df32 engine then combines the (T, n_nodes, k, R)
    profile with the (k, R, B) member scales ON DEVICE (``coef_factors=``),
    so host->device transfer stays O(T + B) instead of O(T * B).

    Detection: envelopes are batch-evaluated at 64 spread-out Gauss times
    (cheap — vectorized numpy over members, no signal-machinery rebuilds)
    and every member must be complex-proportional to the reference member's
    FULL envelope trajectory at all of them; the per-member scales are taken
    at the reference trajectory's own peak time, so pulses that idle at
    coarse probes (echo sequences) still resolve. Returns ``None``
    (full-table fallback) when construction fails, carriers are per-member,
    shapes don't normalize, or any proportionality check misses — e.g. a
    pulse-WIDTH sweep changes the shape itself and falls back. The 64-point
    grid is the detection contract: structure narrower than span/64 that
    also varies per member between grid points would be mis-factorized,
    which smooth single-parameter scale families cannot do.
    """
    if k == 0:
        return None  # no time-dependent terms: sampling path handles k=0
    try:
        sigs = list(signals_as_list(params))
    except Exception:
        return None
    if len(sigs) != k:
        return None
    flat_ts = np.asarray(gauss_times).ravel()
    probe_idx = np.unique(
        np.round(np.linspace(0, len(flat_ts) - 1, min(64, len(flat_ts)))).astype(int)
    )
    probe_ts = flat_ts[probe_idx]

    amp_list, prof_list = [], []
    ref_sigs_cache: dict = {}
    for j_sig, s in enumerate(sigs):
        try:
            carriers = np.asarray(s.carrier_freq, dtype=float)
            phases = np.asarray(s.phase, dtype=float)
            raw_envs = [np.asarray(s.envelope(t)) for t in probe_ts]
        except Exception:
            return None
        # envelopes written with jnp sample at f32 when x64 is off — the
        # full coefficient table would be f32-limited identically, so the
        # proportionality tolerance tracks the sampling precision instead
        # of rejecting (profile reconstruction error stays in the same
        # class as the table it replaces)
        f32_sampled = any(
            e.dtype in (np.float32, np.complex64) for e in raw_envs
        )
        rtol = 5e-6 if f32_sampled else 1e-12
        envs = [np.asarray(e, dtype=complex) for e in raw_envs]
        if carriers.ndim > 1:
            return None  # per-member carriers: no shared time profile
        carriers = np.atleast_1d(carriers)
        r = carriers.size
        phase_b = _to_member_by_term(np.asarray(phases, dtype=float), B, r)
        env_b = [_to_member_by_term(e, B, r) for e in envs]
        if phase_b is None or any(e is None for e in env_b):
            return None
        # v[probe, member, term]: full complex amplitude at the probe times
        v = np.stack([e * np.exp(1j * phase_b) for e in env_b], axis=0)
        # reference member: largest magnitude at the probes (member 0 when
        # all probes are silent); its FULL trajectory drives the scales and
        # the verification, so probe-silent pulses still resolve
        bstar = int(np.argmax(np.max(np.abs(v), axis=(0, 2)))) if v.size else 0
        try:
            if bstar not in ref_sigs_cache:
                ref_sigs_cache[bstar] = list(
                    signals_as_list(
                        jax.tree_util.tree_map(lambda x: np.asarray(x)[bstar], params)
                    )
                )
            s_ref = ref_sigs_cache[bstar][j_sig]
            prof_env = _sample_envelope_trajectory(s_ref, flat_ts, r)
            ref_phase = np.broadcast_to(
                np.atleast_1d(np.asarray(s_ref.phase, dtype=float)), (r,)
            )
        except Exception:
            return None
        ref_traj = prof_env * np.exp(1j * ref_phase)[None, :]  # (TN, r)
        scale = max(float(np.max(np.abs(v))), float(np.max(np.abs(ref_traj))))
        if scale == 0.0:
            # reference trajectory AND all members' probe values are zero;
            # accept as the zero signal (a member nonzero only between all
            # 64 probe points would escape — the documented contract)
            amp_list.append(np.zeros((B, r), dtype=complex))
            prof_list.append(np.zeros((len(flat_ts), r), dtype=complex))
            continue
        ratios = np.empty((B, r), dtype=complex)
        for rr in range(r):
            # scales at the reference trajectory's peak time for this term
            istar = int(np.argmax(np.abs(ref_traj[:, rr])))
            ref_val = ref_traj[istar, rr]
            if abs(ref_val) <= 1e-14 * scale:
                # reference silent on the whole grid: others must be too
                if np.max(np.abs(v[:, :, rr])) > rtol * scale:
                    return None
                ratios[:, rr] = 0.0
                continue
            t_star = flat_ts[istar]
            try:
                e_star = _to_member_by_term(
                    np.asarray(s.envelope(t_star), dtype=complex), B, r
                )
            except Exception:
                return None
            if e_star is None:
                return None
            v_star = e_star * np.exp(1j * phase_b)  # (B, r)
            ratios[:, rr] = v_star[:, rr] / ref_val
            # proportionality to the reference trajectory must hold at
            # EVERY probe time (also cross-checks the batched construction
            # against the single-member one)
            resid = (
                v[:, :, rr]
                - ref_traj[probe_idx, rr][:, None] * ratios[None, :, rr]
            )
            if np.max(np.abs(resid)) > rtol * scale:
                return None
        wave = np.exp(2j * np.pi * carriers[None, :] * flat_ts[:, None])
        prof_list.append(ref_traj * wave)
        amp_list.append(ratios)

    r_max = max(a.shape[1] for a in amp_list)
    T_total = len(flat_ts)
    A = np.zeros((k, r_max, B), dtype=np.complex128)
    P = np.zeros((T_total, k, r_max), dtype=np.complex128)
    for j, (a, p) in enumerate(zip(amp_list, prof_list)):
        A[j, : a.shape[1]] = a.T
        P[:, j, : p.shape[1]] = p
    shape = np.asarray(gauss_times).shape
    return A, P.reshape(shape + (k, r_max))


def _sample_coefficients_f64(signals_as_list, params, gauss_times, k, B):
    """Sample per-member signal values at the Gauss times, in host float64.

    Fast path: when the envelopes are constant (probed on the first and last
    member), each signal factorizes as ``c_j(t, b) = Re[sum_r A_jbr
    e^{i 2 pi nu_jr t}]`` with member-independent carriers — the time tables
    are then one vectorized matmul instead of a full per-member sweep of
    the signal machinery (~10x less host time on large sweeps). Falls back
    to the general per-member evaluation otherwise.
    """
    shape = gauss_times.shape
    flat_ts = gauss_times.ravel()
    # 16 spread probes: an envelope that idles at a few coarse probes but
    # pulses between them (echo-style schedules) must not be mis-detected
    # as constant (the per-member amplitude loop below re-verifies
    # constancy at two of these probes for every member)
    probe_ts = _spread_probe_ts(flat_ts, 16)

    def member_params(b):
        return jax.tree_util.tree_map(lambda x: np.asarray(x)[b], params)

    def probe(b):
        """(carriers, amplitudes) per signal if constant-envelope, else None."""
        sigs = list(signals_as_list(member_params(b)))
        out = []
        for s in sigs:
            envs = [np.atleast_1d(np.asarray(s.envelope(t), dtype=complex)) for t in probe_ts]
            if not all(np.allclose(e, envs[0], rtol=1e-14, atol=1e-14) for e in envs[1:]):
                return None
            carriers = np.atleast_1d(np.asarray(s.carrier_freq, dtype=float))
            phases = np.atleast_1d(np.asarray(s.phase, dtype=float))
            out.append((carriers, envs[0] * np.exp(1j * phases)))
        return out

    first = probe(0)
    last = probe(B - 1) if (first is not None and B > 1) else first
    constant = (
        first is not None
        and last is not None
        and all(np.array_equal(f[0], l[0]) for f, l in zip(first, last))
    )

    coefs = np.empty(shape + (k, B), dtype=np.float64)
    if constant:
        # one signal construction per member; extract every signal's complex
        # amplitude from it (reconstructing per (member, signal) pair costs
        # k extra Signal/RWA-map builds per member — measured dominant)
        all_amps = [
            np.empty((B, first[j][0].shape[0]), dtype=complex) for j in range(k)
        ]
        for j in range(k):
            all_amps[j][0] = first[j][1]
            all_amps[j][B - 1] = last[j][1]
        mid_t = probe_ts[len(probe_ts) // 2]
        for b in range(1, B - 1):
            sigs = list(signals_as_list(member_params(b)))
            for j, s in enumerate(sigs):
                env = np.atleast_1d(np.asarray(s.envelope(probe_ts[0]), dtype=complex))
                env2 = np.atleast_1d(np.asarray(s.envelope(mid_t), dtype=complex))
                if not np.allclose(env2, env, rtol=1e-14, atol=1e-14):
                    constant = False  # THIS member is time-dependent
                    break
                ph = np.atleast_1d(np.asarray(s.phase, dtype=float))
                all_amps[j][b] = env * np.exp(1j * ph)
            if not constant:
                break
    if constant:
        for j in range(k):
            carriers = first[j][0]
            waves = np.exp(2j * np.pi * carriers[:, None] * flat_ts[None, :])
            coefs[..., j, :] = np.moveaxis(
                np.real(all_amps[j] @ waves).reshape((B,) + shape), 0, -1
            )
    else:
        for b in range(B):
            coefs[..., b] = np.asarray(signals_as_list(member_params(b))(gauss_times))
    return coefs


def _adaptive_df_grid(
    signals_as_list, params, static_fb, ops_fb, omega, t0, tf,
    magnus_order, tol, probes=None,
):
    """Host-f64 adaptive step grid for the df32 engine.

    Greedy step-doubling walk of PROBE sweep members (default: first, middle
    and last — for amplitude sweeps the stiffest member is an endpoint): per
    trial step, the Magnus-``magnus_order`` propagator over ``[t, t+dt]`` is
    compared against two half-steps (``err ~ C dt^(2*magnus_order+1)``), with
    the tolerance distributed per unit time (``tol * dt / span``). The merged
    grid takes the pointwise-minimum dt over the probes, so the full sweep
    replays a grid that satisfied every probe. Steps concentrate where the
    generator actually varies — on Gaussian-envelope sweeps the quiet tails
    take much larger steps than a uniform grid sized for the peak.

    Cost: O(grid * probes) host expm's of the solve dimension — negligible
    for the small-dim sweeps the df engine targets.
    """
    from scipy.linalg import expm

    from ..ops.df_sweep import MAGNUS_NODES

    nodes = MAGNUS_NODES[magnus_order]
    leaves = jax.tree_util.tree_leaves(params)
    B = int(np.asarray(leaves[0]).shape[0]) if leaves else 1
    if probes is None:
        probes = sorted({0, B // 2, B - 1})
    span = tf - t0
    sqrt15 = np.sqrt(15.0)

    def magnus_m(sig, t, dt):
        g = []
        for c in nodes:
            tau = t + c * dt
            cv = np.atleast_1d(np.asarray(sig(tau), dtype=float))
            a = static_fb + np.tensordot(cv, ops_fb, axes=1)
            g.append(a * np.exp(1j * omega * tau))
        if magnus_order == 2:
            return dt / 2 * (g[0] + g[1]) + _P2 * dt * dt * (
                g[1] @ g[0] - g[0] @ g[1]
            )
        a1 = dt * g[1]
        a2 = sqrt15 / 3 * dt * (g[2] - g[0])
        a3 = 10.0 / 3 * dt * (g[2] - 2 * g[1] + g[0])
        c1 = a1 @ a2 - a2 @ a1
        t2 = 2 * a3 + c1
        c2 = (t2 @ a1 - a1 @ t2) / 60
        left = c1 - (20 * a1 + a3)
        right = a2 + c2
        return a1 + a3 / 12 + (left @ right - right @ left) / 240

    p = 2 * magnus_order  # local error ~ dt^(p+1); tol_step ~ dt cancels one

    def walk(sig):
        t, dt, steps = t0, span / 64, []
        for _ in range(200_000):
            if t >= tf - 1e-12 * span:
                return steps
            dt = min(dt, tf - t)
            u1 = expm(magnus_m(sig, t, dt))
            u2 = expm(magnus_m(sig, t + dt / 2, dt / 2)) @ expm(
                magnus_m(sig, t, dt / 2)
            )
            err = float(np.max(np.abs(u1 - u2)))
            tol_step = tol * dt / span
            if err <= tol_step or dt <= 1e-7 * span:
                steps.append((t, dt))
                t += dt
            factor = 0.85 * (tol_step / max(err, 1e-300)) ** (1.0 / p)
            dt = dt * min(max(factor, 0.3), 3.0)
        raise DynamicsError(
            "df_grid='adaptive' did not converge on a step grid (200k trial "
            "steps); the tolerance may be unreachable for this generator."
        )

    def member_params(b):
        return jax.tree_util.tree_map(lambda x: np.asarray(x)[b], params)

    fns = []
    for b in probes:
        steps = walk(signals_as_list(member_params(b)))
        fns.append((np.array([s[0] for s in steps]), np.array([s[1] for s in steps])))

    def dt_at(t):
        return min(float(np.interp(t, ts, ds)) for ts, ds in fns)

    t, dts = t0, []
    while t < tf - 1e-12 * span:
        d = min(dt_at(t), tf - t)
        dts.append(d)
        t += d
        if len(dts) > 500_000:
            raise DynamicsError("df_grid='adaptive' produced a pathological grid.")
    return np.asarray(dts)


def _df_eval_slots(t_eval, dts, t0: float, tf: float):
    """Fit ``t_eval`` into the df step grid ``t0 + cumsum(dts)``.

    Unlike the f32 fixed-step engines (scalar ``dt``), the df32 engine takes
    per-step sizes, so OFF-GRID evaluation times are handled exactly by
    splitting the containing step at the requested time (the split can only
    shrink steps, so the Magnus truncation error never grows). Points within
    1e-9-relative of an existing edge snap to it instead of creating a
    sliver step.

    Returns ``(dts, eval_slots, include_t0)``: the (possibly refined) step
    sizes, a length-T' tuple of per-step trajectory slots (-1 = no store,
    else the state AFTER that step writes slot ``eval_slots[j]``), and
    whether ``t_eval[0]`` is ``t0`` itself. ``(dts, None, False)`` when
    ``t_eval`` is None.
    """
    dts = np.asarray(dts, dtype=float)
    if t_eval is None:
        return dts, None, False
    te = np.atleast_1d(np.asarray(t_eval, dtype=float))
    if te.ndim != 1 or te.size == 0:
        raise DynamicsError("t_eval must be a non-empty 1d sequence of times.")
    if te.size > 1 and np.any(np.diff(te) <= 0):
        raise DynamicsError("t_eval must be strictly increasing.")
    if te[0] < t0 - 1e-9 or te[-1] > tf + 1e-9 * max(1.0, abs(tf)):
        raise DynamicsError(f"t_eval must lie within t_span ({t0}, {tf}).")
    include_t0 = te[0] - t0 <= 1e-9 * max(1.0, abs(t0))
    kept = te[1:] if include_t0 else te

    tol = lambda t: 1e-9 * max(1.0, abs(t))
    edges = t0 + np.cumsum(dts)  # time AFTER step j
    new_dts: list = []
    slots: list = []
    prev = t0
    i = 0
    for e in edges:
        # eval points strictly inside (prev, e) split the step at the point
        while i < len(kept) and kept[i] < e - tol(e):
            t = float(kept[i])
            if t - prev <= 0.0:
                raise DynamicsError(
                    "t_eval contains points too close together to separate "
                    f"on the step grid (around t={t})."
                )
            new_dts.append(t - prev)
            slots.append(i)
            prev = t
            i += 1
        new_dts.append(float(e) - prev)
        if i < len(kept) and abs(kept[i] - e) <= tol(e):
            slots.append(i)
            i += 1
        else:
            slots.append(-1)
        prev = float(e)
    if i < len(kept):
        # can only happen for points past the last edge within the span
        # tolerance — snap them to the final edge if free, else error
        raise DynamicsError(
            "t_eval points could not be placed on the step grid; the last "
            f"{len(kept) - i} point(s) fall beyond the final step edge "
            f"({edges[-1]})."
        )
    eval_slots = tuple(slots) if len(kept) else None
    return np.asarray(new_dts), eval_slots, bool(include_t0)


def _fused_sweep_solve_df(
    model, signals_as_list, params, dts, static_fb, ops_fb, omega,
    y0_fb, vectorized_lindblad, t0, expm_order, chunk_b, magnus_order,
    fast_commutators=True, horner_df_tail=6, devices=None,
    eval_slots=None, include_t0=False,
):
    """df32 branch of :func:`fused_sweep_solve` (host-facing, float64 I/O).

    Signals are sampled on host in float64 (the numpy path of the signal
    machinery), then the whole sweep runs through
    :func:`~qiskit_dynamics_tpu.ops.df_sweep.sweep_expm_magnus_df` on the
    (possibly non-uniform) step grid ``dts``.
    """
    import warnings

    from ..ops.df_sweep import MAGNUS_NODES, sweep_expm_magnus_df

    leaves = jax.tree_util.tree_leaves(params)
    if any(isinstance(leaf, jax.core.Tracer) for leaf in leaves):
        raise DynamicsError(
            'fused_sweep_solve(precision="df32") is host-facing: params must be '
            "concrete (signals are sampled in float64 on host), not traced."
        )
    for arr, name in ((static_fb, "operators"), (np.asarray(y0_fb), "y0")):
        if arr.dtype not in (np.complex128, np.float64):
            warnings.warn(
                f"df32 precision requested but the model's {name} are stored in "
                f"{arr.dtype}; accuracy is limited by that representation. Build "
                "the model from float64/complex128 host arrays.",
                stacklevel=3,
            )
    B = int(np.asarray(leaves[0]).shape[0]) if leaves else 1
    k = ops_fb.shape[0]
    dts = np.asarray(dts, dtype=np.float64)
    t_start = t0 + np.concatenate([[0.0], np.cumsum(dts)[:-1]])
    gauss_times = (
        t_start[:, None] + dts[:, None] * MAGNUS_NODES[magnus_order][None, :]
    )
    # constant-envelope sweeps factorize: ship (k, R, B) amplitudes + tiny
    # phase tables and assemble the coefficient table ON DEVICE (df32
    # arithmetic) — the full (T, n_nodes, k, B) table is ~240 MB for a
    # 10k-member 500-step sweep, and sampling it on the host dominates
    flat_ts = gauss_times.ravel()
    factors = _constant_envelope_factors(signals_as_list, params, flat_ts, k, B)
    if factors is None:
        # fixed-shape envelope with member-dependent complex scale
        # (amplitude calibration of a time-varying pulse): ship one
        # reference profile + per-member scales instead of the full table
        factors = _rank1_envelope_factors(signals_as_list, params, gauss_times, k, B)
    coefs = (
        None
        if factors is not None
        else _sample_coefficients_f64(signals_as_list, params, gauss_times, k, B)
    )

    y0_fb = np.asarray(y0_fb, dtype=np.complex128)
    m = 1 if y0_fb.ndim == 1 else y0_fb.shape[1]
    if m > 1:
        if factors is not None:
            factors = (np.repeat(factors[0], m, axis=-1), factors[1])
        else:
            coefs = np.repeat(coefs, m, axis=-1)
        y0_cols = np.tile(y0_fb, (1, B))  # member-major, column-minor
    else:
        y0_cols = np.broadcast_to(y0_fb[:, None], (y0_fb.shape[0], B))

    want_traj = eval_slots is not None or include_t0
    traj = None
    out = sweep_expm_magnus_df(
        static_fb, ops_fb, omega, coefs, y0_cols, dt=dts, t0=t0,
        magnus_order=magnus_order, order=max(expm_order, 12), chunk_b=chunk_b,
        hermitian=_all_anti_hermitian(static_fb, ops_fb),
        fast_commutators=fast_commutators, horner_df_tail=horner_df_tail,
        coef_factors=factors, devices=devices, eval_slots=eval_slots,
    )
    yf, traj = out if eval_slots is not None else (out, None)
    if want_traj:
        pieces = []
        if include_t0:
            pieces.append(np.asarray(y0_cols, dtype=complex)[None])
        if traj is not None:
            pieces.append(traj)
        traj = pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=0)
        # host-numpy collector: jnp would downcast complex128 -> complex64
        # with x64 off and throw away the df precision
        if vectorized_lindblad:
            n = model.dim
            rho = np.transpose(traj[:, :, :B].reshape(-1, n, n, B), (3, 0, 2, 1))
            return np.asarray(model.rotating_frame.operator_out_of_frame_basis(rho))
        traj = np.asarray(
            model.rotating_frame.state_out_of_frame_basis(traj[:, :, : B * m])
        )
        if m == 1:
            return np.transpose(traj, (2, 0, 1))  # (B, n_eval, dim)
        n_eval_t, dim = traj.shape[0], traj.shape[1]
        return np.moveaxis(traj.reshape(n_eval_t, dim, B, m), 2, 0)

    if vectorized_lindblad:
        n = model.dim
        rho = np.transpose(yf.reshape(n, n, B), (2, 1, 0))  # (B, n, n)
        return np.asarray(model.rotating_frame.operator_out_of_frame_basis(rho))
    yf = np.asarray(model.rotating_frame.state_out_of_frame_basis(yf))
    if m == 1:
        return yf.T
    return np.moveaxis(yf.reshape(yf.shape[0], B, m), 1, 0)


def fused_adaptive_sweep_solve(
    model,
    signals_fn: Callable,
    params,
    t_span,
    y0,
    atol: float = 1e-6,
    rtol: float = 1e-6,
    max_steps: int = 4096,
    h0: float = 1e-2,
    tile_b: Optional[int] = None,
    interpret: bool = False,
    rwa_signal_map: Optional[Callable] = None,
    envelope_resolution: Optional[int] = None,
    bucket_lanes: bool = True,
    t_eval=None,
    differentiable: bool = True,
    mesh=None,
):
    r"""Lockstep-adaptive dopri5 sweep solve.

    Engine (``ops/adaptive_sweep.py``): a Pallas Triton kernel on a GPU —
    one program per group of ``tile_b`` members runs the whole adaptive loop
    on chip — and its XLA twin elsewhere; ``interpret=True`` runs the kernel
    in the Pallas interpreter (CPU tests). ``tile_b`` (a power of two of at
    least 16 on the kernel; by default
    :func:`~qiskit_dynamics_tpu.ops.adaptive_sweep.lockstep_tile_b`: 32 up to
    dim 16, 16 above) is the lockstep group: the members that share one step
    control.

    Differentiability (``differentiable=True``, the default): the solve sits
    under ``jax.grad``/``jax.vjp`` via a custom VJP — the primal
    additionally records its accepted step sequence per group, and the
    backward pass replays that exact grid as a fixed-grid dopri5 adjoint in
    XLA (checkpointed scan; see ``ops/adaptive_replay.py``). Gradients flow
    through the accepted states w.r.t. the sweep parameters (envelopes/
    amplitudes via ``signals_fn``), ``y0``, and the model operators; step-size
    selection is non-differentiable by convention. Trajectory outputs
    (``t_eval``) are differentiable too. Forward-only calls pay nothing.
    Set ``differentiable=False`` to call the bare engine (debugging).

    Heterogeneous sweeps: each group shares a single lockstep step control,
    so by default (``bucket_lanes=True``) sweep members are sorted by total
    drive magnitude before grouping — similar stiffness lands in the same
    group — and results are un-permuted on return. Disable to preserve the
    raw group assignment (e.g. for deterministic debugging).

    Adaptive counterpart of :func:`fused_sweep_solve` built on
    :func:`~qiskit_dynamics_tpu.ops.adaptive_sweep.sweep_dopri5_lockstep`.

    Multi-device: ``mesh=`` (a ``jax.sharding.Mesh``) shards the sweep batch
    over the mesh's ``"data"`` axis (``parallel.pshard_batch``) — each device
    runs the engine and its stiffness bucketing on its own shard,
    SPMD with no collectives on the solve path; batches pad to a multiple
    of the axis size and trim on return. Gradients shard too, but wrap the
    loss in ``jax.jit`` (``jit(grad(loss))``): jax cannot yet evaluate the
    custom-VJP's inner call eagerly inside ``shard_map``.

    Precision: the engine arithmetic is hard-float32 with EFT-reduced phase
    arguments (``ops/trig_reduce.py``); tolerances are honored down to
    ~1e-7-class (tighten ``atol``/``rtol`` below the 1e-6 default when
    accuracy matters more than steps). For 1e-8-class accuracy use
    :func:`fused_sweep_solve` with ``precision="df32"`` or the chebyshev
    interpolated sweep.

    Signal handling: the engine evaluates
    ``c_j(t, b) = Re[E_jb(t) e^{i 2 pi nu_j t}]`` at arbitrary step times.
    With ``envelope_resolution=None`` every signal produced by
    ``signals_fn`` (after the optional ``rwa_signal_map``) must have a
    CONSTANT envelope (``E_jb = envelope * e^{i phase}``); with
    ``envelope_resolution=S`` arbitrary envelopes are supported via a
    piecewise-constant table of ``S`` midpoint samples over ``[t0, tf]``
    (exact for ``DiscreteSignal`` envelopes when ``S`` matches the sample
    grid; O((tf/S)^2) approximation otherwise).

    Like :func:`fused_sweep_solve`, also accepts a vectorized
    ``LindbladModel`` (density-matrix ``y0``; ``signals_fn`` returns a
    ``(hamiltonian_signals, dissipator_signals)`` tuple).

    Trajectories: ``t_eval`` (strictly increasing times in ``t_span``; need
    NOT lie on any grid — adaptive steps clip to them exactly) switches the
    return to ``(B, len(t_eval), ...)``.

    Returns (B, dim) final states at ``t_span[1]`` (standard basis), or
    (B, dim, dim) density matrices for a vectorized Lindblad model; with
    ``t_eval``, the corresponding ``(B, n_eval, ...)`` trajectories.
    """
    if mesh is not None:
        # multi-device: shard the sweep batch over the mesh's data axis —
        # each device runs the lockstep engine (and its stiffness bucketing)
        # on its own shard; SPMD with no collectives on the solve path
        from ..parallel.sweep import pshard_batch

        def _local(p):
            return fused_adaptive_sweep_solve(
                model, signals_fn, p, t_span=t_span, y0=y0, atol=atol,
                rtol=rtol, max_steps=max_steps, h0=h0, tile_b=tile_b,
                interpret=interpret, rwa_signal_map=rwa_signal_map,
                envelope_resolution=envelope_resolution,
                bucket_lanes=bucket_lanes, t_eval=t_eval,
                differentiable=differentiable, mesh=None,
            )

        return pshard_batch(_local, mesh=mesh)(params)

    if min(atol, rtol) < 3e-8:
        import warnings

        warnings.warn(
            "fused_adaptive_sweep_solve runs hard-float32; with EFT-reduced "
            "phase arguments the practical floor is ~1e-7-class — "
            f"atol/rtol=({atol}, {rtol}) below ~3e-8 only spends "
            "steps on roundoff-dominated error estimates. For 1e-8-class "
            'accuracy use fused_sweep_solve(..., precision="df32") or the '
            "chebyshev interpolated sweep.",
            stacklevel=2,
        )

    args, statics, finish = adaptive_sweep_inputs(
        model, signals_fn, params, t_span, y0, tile_b=tile_b,
        rwa_signal_map=rwa_signal_map, envelope_resolution=envelope_resolution,
        bucket_lanes=bucket_lanes, t_eval=t_eval,
    )
    tf, t0, env_dt, eval_ts, tile_b = (
        statics[key] for key in ("tf", "t0", "env_dt", "eval_ts", "tile_b")
    )
    if differentiable:
        # custom-vjp wrapper: lockstep primal (recording its accepted
        # steps), recorded-grid XLA replay adjoint (ops/adaptive_replay.py)
        out_kernel = sweep_dopri5_lockstep_ad(
            *args, tf, t0, atol, rtol, max_steps, h0, tile_b, env_dt, eval_ts,
            interpret,
        )
    else:
        out_kernel = sweep_dopri5_lockstep_split(
            *args, tf=tf, t0=t0, atol=atol, rtol=rtol, max_steps=max_steps,
            h0=h0, tile_b=tile_b, env_dt=env_dt, eval_ts=eval_ts,
            interpret=interpret,
        )
    return finish(out_kernel)


def adaptive_sweep_inputs(
    model, signals_fn, params, t_span, y0, tile_b: Optional[int] = None,
    rwa_signal_map=None, envelope_resolution=None, bucket_lanes: bool = True,
    t_eval=None,
):
    """The lockstep engine's inputs for :func:`fused_adaptive_sweep_solve`.

    Returns ``(args, statics, finish)``: the positional array arguments of
    :func:`~qiskit_dynamics_tpu.ops.adaptive_sweep.sweep_dopri5_lockstep_split`,
    its static ``tf``/``t0``/``env_dt``/``eval_ts``/``tile_b`` (resolved),
    and ``finish(out)``
    mapping the engine's frame-basis output to the user-facing result.
    Arguments as for :func:`fused_adaptive_sweep_solve`.
    """
    (
        vectorized_lindblad,
        _,
        static_fb,
        ops_fb,
        omega,
        t0,
        tf,
    ) = _extract_generator_data(model, t_span, "fused_adaptive_sweep_solve")
    k = ops_fb.shape[0]

    def flat_signals(p):
        """signals_fn output -> flat list (Lindblad tuples concatenated)."""
        sigs = signals_fn(p)
        if isinstance(sigs, tuple):
            if rwa_signal_map is not None:
                sigs = rwa_signal_map(sigs)
            ham_sigs, dis_sigs = sigs
            return list(ham_sigs) + list(dis_sigs or [])
        if rwa_signal_map is not None:
            sigs = rwa_signal_map(sigs)
        return list(sigs)

    # collect the (shared) carrier frequencies from member-0 and member-(-1)
    # probes; a mapped signal may be a SignalSum (e.g. RWA copies) — all its
    # terms must share one carrier, and the complex amplitudes add. Carrier
    # SWEEPS are not supported (the engine uses one frequency per signal).
    def probe_carriers(member_params):
        sigs = flat_signals(member_params)
        if len(sigs) != k:
            raise DynamicsError(
                f"signals_fn (after any rwa_signal_map) must produce {k} signals to "
                f"match the model's operators; got {len(sigs)}."
            )
        out = []
        for s in sigs:
            carrier = s.carrier_freq
            if isinstance(carrier, jax.core.Tracer):
                raise DynamicsError(
                    "fused_adaptive_sweep_solve does not support sweeping the carrier "
                    "frequency — carriers must be the same for every sweep member."
                )
            carriers = np.atleast_1d(np.asarray(carrier, dtype=float))
            if not np.allclose(carriers, carriers[0]):
                raise DynamicsError(
                    "fused_adaptive_sweep_solve requires each (summed) signal to have "
                    "a single carrier frequency."
                )
            out.append(2 * np.pi * carriers[0])
        return np.asarray(out), sigs

    freqs, probe_sigs = probe_carriers(jax.tree_util.tree_map(lambda x: x[0], params))
    freqs_last, _ = probe_carriers(jax.tree_util.tree_map(lambda x: x[-1], params))
    if not np.allclose(freqs, freqs_last):
        raise DynamicsError(
            "fused_adaptive_sweep_solve does not support sweeping the carrier "
            "frequency — carriers must be the same for every sweep member."
        )

    if envelope_resolution is None:
        env_dt = 0.0
        # reject non-constant envelopes (silently wrong otherwise): probe the
        # member-0 envelopes at a few interior times. Under a trace (params
        # traced through jit) the values cannot be inspected — skipped then.
        probe_ts = t0 + np.array([0.0, 0.37, 0.71]) * (tf - t0)
        for s in probe_sigs:
            vals = [s.envelope(t) for t in probe_ts]
            if any(isinstance(v, jax.core.Tracer) for v in vals):
                continue
            vals = np.asarray(
                [np.sum(np.atleast_1d(np.asarray(v, dtype=complex))) for v in vals]
            )
            if not np.allclose(vals, vals[0], rtol=1e-12, atol=1e-12):
                raise DynamicsError(
                    "fused_adaptive_sweep_solve with envelope_resolution=None requires "
                    "constant-envelope signals; pass envelope_resolution=S for "
                    "time-dependent pulse shapes."
                )

        def amplitudes(p):
            amps_k = []
            for s in flat_signals(p):
                env = jnp.atleast_1d(jnp.asarray(s.envelope(0.0), dtype=complex))
                ph = jnp.atleast_1d(jnp.asarray(s.phase))
                amps_k.append(jnp.sum(env * jnp.exp(1j * ph)))
            return jnp.stack(amps_k)

        amps = jnp.moveaxis(jax.vmap(amplitudes)(params), 0, -1)  # (k, B)
    else:
        n_env = int(envelope_resolution)
        env_dt = (tf - t0) / n_env
        env_times = t0 + (np.arange(n_env) + 0.5) * env_dt
        carrier_phase = np.exp(-1j * freqs[:, None] * env_times[None, :])  # (k, S)

        def amplitudes(p):
            rows = [
                s.complex_value(jnp.asarray(env_times)) * carrier_phase[j]
                for j, s in enumerate(flat_signals(p))
            ]
            return jnp.stack(rows)  # (k, S)

        amps = jnp.moveaxis(jax.vmap(amplitudes)(params), 0, -1)  # (k, S, B)

    # stiffness bucketing: each group shares one adaptive step control
    # (lockstep at the worst member), so one stiff member stalls its whole
    # group. Sorting members by total drive magnitude puts similar
    # stiffness into the same group — a pure permutation (exact), applied
    # here and inverted on the outputs. Works under trace (argsort/gather).
    order = inv_order = None
    if bucket_lanes:
        key = jnp.sum(jnp.abs(amps), axis=tuple(range(amps.ndim - 1)))  # (B,)
        order = jnp.argsort(key)
        inv_order = jnp.argsort(order)
        amps = amps[..., order]

    if vectorized_lindblad:
        rho_fb = np.asarray(model.rotating_frame.operator_into_frame_basis(np.asarray(y0)))
        y0_fb = rho_fb.ravel(order="F")  # column-stacking vec
        solve_dim = model.dim**2
    else:
        y0_fb = np.asarray(model.rotating_frame.state_into_frame_basis(np.asarray(y0)))
        solve_dim = model.dim
    eval_ts = None
    include_t0 = False
    if t_eval is not None:
        te = np.atleast_1d(np.asarray(t_eval, dtype=float))
        if te.ndim != 1 or te.size == 0:
            raise DynamicsError("t_eval must be a non-empty 1d sequence of times.")
        if te.size > 1 and np.any(np.diff(te) <= 0):
            raise DynamicsError("t_eval must be strictly increasing.")
        if te[0] < t0 - 1e-9 or te[-1] > tf + 1e-9 * max(1.0, abs(tf)):
            raise DynamicsError(f"t_eval must lie within t_span ({t0}, {tf}).")
        # snap tolerance must cover the containment slack above: a te[0] in
        # [t0 - 1e-9, t0) would otherwise produce a negative elapsed time
        include_t0 = te[0] - t0 <= 1e-9 * max(1.0, abs(t0))
        rel = (te[1:] if include_t0 else te) - t0
        eval_ts = tuple(float(x) for x in rel) if rel.size else None

    tile_b = lockstep_tile_b(solve_dim) if tile_b is None else int(tile_b)
    amps, y0_cols, B, m = _expand_lanes(amps, y0_fb, solve_dim, tile_b)
    # frequency splits happen HERE (host f64 in hand; custom_vjp traces its
    # array arguments)
    omega_hi, omega_lo = (jnp.asarray(a) for a in split_array(omega))
    freq_hi, freq_lo = (jnp.asarray(a) for a in split_array(freqs))
    args = (static_fb, ops_fb, omega_hi, omega_lo, freq_hi, freq_lo, amps, y0_cols)
    statics = dict(tf=tf, t0=t0, env_dt=env_dt, eval_ts=eval_ts, tile_b=tile_b)

    def finish(out_engine):
        if t_eval is not None:
            yf, traj = out_engine if eval_ts is not None else (out_engine, None)
            pieces = []
            if include_t0:
                pieces.append(jnp.asarray(y0_cols, dtype=yf.dtype)[None])
            if traj is not None:
                pieces.append(traj)
            traj = pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, axis=0)
            out = _collect_trajectory(model, traj, B, m, vectorized_lindblad)
            if bucket_lanes:
                out = out[inv_order]
            return out

        yf = out_engine
        if vectorized_lindblad:
            n = model.dim
            rho = jnp.transpose(yf[:, :B].reshape(n, n, B), (2, 1, 0))  # (B, n, n)
            out = model.rotating_frame.operator_out_of_frame_basis(rho)
        else:
            out = _collect_lanes(model, yf, B, m)
        if bucket_lanes:
            out = out[inv_order]
        return out

    return args, statics, finish


def _expand_lanes(lane_data, y0_fb, dim: int, tile_b: int):
    """Map sweep members x y0 columns onto engine lanes.

    1d ``y0_fb`` (dim,): one lane per sweep member. 2d ``y0_fb`` (dim, m) —
    e.g. the identity for unitary/gate sweeps: each member occupies ``m``
    consecutive lanes (per-lane data repeated, y0 columns tiled). ``y0_fb`` is
    already frame-basis. Pads the lane axis to a multiple of ``tile_b``.
    Returns (lane_data, y0_cols, B, m).
    """
    y0_fb = np.asarray(y0_fb)
    m = 1 if y0_fb.ndim == 1 else y0_fb.shape[1]
    B = lane_data.shape[-1]
    if m > 1:
        lane_data = jnp.repeat(lane_data, m, axis=-1)
    total = B * m
    pad = (-total) % tile_b
    if pad:
        filler = jnp.broadcast_to(lane_data[..., :1], lane_data.shape[:-1] + (pad,))
        lane_data = jnp.concatenate([lane_data, filler], axis=-1)

    if m == 1:
        y0_cols = jnp.broadcast_to(jnp.asarray(y0_fb)[:, None], (dim, total + pad))
    else:
        cols = jnp.tile(jnp.asarray(y0_fb), (1, B))  # member-major, column-minor
        pad_cols = jnp.broadcast_to(cols[:, :1], (dim, pad))
        y0_cols = jnp.concatenate([cols, pad_cols], axis=-1)
    return lane_data, y0_cols, B, m


def _collect_lanes(model, yf, B: int, m: int):
    """Inverse of :func:`_expand_lanes`: (dim, lanes) -> (B, dim) or (B, dim, m)."""
    yf = yf[:, : B * m]
    yf = model.rotating_frame.state_out_of_frame_basis(yf)
    if m == 1:
        return yf.T
    return jnp.moveaxis(yf.reshape(yf.shape[0], B, m), 1, 0)
