r"""Monte Carlo wavefunction (quantum-trajectory) unraveling of the Lindblad
equation.

Capability beyond the reference (qiskit-dynamics has no trajectory
unraveling; its open-system path is the density-matrix/vectorized Lindblad
solve). The standard MCWF method (Dalibard-Castin-Molmer) evolves pure
states under the non-Hermitian effective generator

.. math::

    G_{\mathrm{eff}}(t) = -iH(t)
        - \tfrac12 \sum_k \gamma_k(t)\, L_k^\dagger L_k,

letting the norm decay, and applies a jump :math:`\psi \to L_k\psi/\|L_k\psi\|`
(channel :math:`k` drawn with probability :math:`\propto \gamma_k\|L_k\psi\|^2`)
whenever the squared norm crosses a uniform threshold. Averaging
:math:`|\psi\rangle\langle\psi|` over trajectories reproduces the Lindblad
density matrix with :math:`O(1/\sqrt{N})` statistical error — at
:math:`O(N\, n)` state memory instead of :math:`O(n^2)`, and embarrassingly
parallel.

Design (nothing like the host-loop trajectory solvers in CPU libraries):

- **Trajectories ride the lanes.** The state is one ``(dim, n_traj)``
  array. All trajectories share the same signals, hence the same effective
  propagator: each step is ONE small ``expm`` (:func:`.ops.expm.expm_taylor`,
  Paterson-Stockmeyer) plus ONE ``(n, n) @ (n, B)`` matmul — per-step
  cost is independent of the trajectory count until the matmul saturates.
- **No data-dependent control flow.** Jumps are per-lane ``where`` selects:
  every step computes all ``K`` jump candidates with one
  ``(K, n, n) x (n, B)`` einsum and masks them in. XLA sees one static
  ``lax.scan``.
- **Frames are elementwise phase masks.** The model stores operators in the
  frame eigenbasis (the repo-wide contract), so the rotating-frame
  transform of both :math:`H` and :math:`L_k^\dagger L_k` is one
  ``exp((d_j - d_i) t)`` mask on a combined matrix, and jump candidates
  need only two diagonal phase multiplies around the frame-basis
  :math:`L_k`. The coarse-``dt`` advantage of the frame survives
  unraveling.

Integrator: midpoint (Magnus-1) exponential stepping, second-order in the
deterministic flow, with SECOND-ORDER jump placement (default,
``jump_placement="interp"``): when a lane's squared norm crosses its
waiting-time threshold within a step, the crossing time :math:`\tau^*` is
located by log-linear interpolation of the norm (exact when the decay rate
is constant across the step, :math:`O(dt^2)` otherwise), the jump operator
is applied to the linearly interpolated state :math:`\psi(\tau^*)`, and the
post-jump state is evolved over the step remainder with the shared
propagator's linear fraction :math:`c + \theta\,(Uc - c)`,
:math:`\theta = (t_{i+1}-\tau^*)/dt`. Every correction is :math:`O(dt^2)`
local on events of probability :math:`O(\gamma\,dt)`, so the weak error is
:math:`O(dt^2)` overall — vs :math:`O(\gamma\,dt)` for the standard
jump-at-step-boundary discretization (kept as ``jump_placement="end"``).
All control flow stays per-lane
``where`` selects — the lockstep lane layout is unchanged, and the only
extra device work is one shared matvec per step. Multiple crossings within
one step resolve one step late (an :math:`O((\gamma dt)^2)`-probability
event displaced by :math:`\le dt`: an :math:`O(dt^2)` weak contribution).

Randomness is explicit (a ``jax.random`` key), so runs are reproducible
and trajectory batches can be sharded by splitting keys. The initial
waiting-time thresholds can be supplied explicitly (``thresholds=``) for
stratified/low-discrepancy sampling — on single-channel problems this turns
the trajectory average into a deterministic quadrature (error
:math:`O(1/N)` instead of :math:`O(1/\sqrt N)`), and it is how the test
suite measures placement bias below the statistical floor. Forward-only by
design: gradients through jump discontinuities are not meaningful; for
differentiable open-system solves use the vectorized Lindblad path or
:func:`.analysis.lindblad_steady_state`.

Reference baseline for the Lindblad semantics being unraveled:
``/root/reference/qiskit_dynamics/models/lindblad_model.py`` (the
density-matrix form this estimator converges to).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..exceptions import DynamicsError

__all__ = [
    "solve_mc_trajectories",
    "solve_mc_trajectories_sweep",
    "MCResult",
    "mc_expectation",
]


class MCResult(NamedTuple):
    """Monte Carlo unraveling result.

    Attributes:
        t: ``(n_save + 1,)`` save times (including ``t0``).
        states: ``(n_save + 1, n_traj, dim)`` normalized trajectory states
            in the model's ROTATING FRAME, original basis — the same
            convention as ``Solver.solve`` and the reference; apply
            ``model.rotating_frame.state_out_of_frame(t, y)`` for
            lab-frame states.
        density: ``(n_save + 1, dim, dim)`` trajectory-averaged density
            matrices ``E[|psi><psi|]``.
        jump_counts: ``(n_traj,)`` number of jumps per trajectory over the
            full interval.
    """

    t: jnp.ndarray
    states: jnp.ndarray
    density: jnp.ndarray
    jump_counts: jnp.ndarray


def mc_expectation(states, operator):
    """``(..., n_traj, dim)`` normalized states -> ``(...,)`` mean ``<A>``.

    Real part of the trajectory-averaged expectation value (for a Hermitian
    ``operator`` the imaginary part is statistical zero).
    """
    states = jnp.asarray(states)
    operator = jnp.asarray(operator)
    vals = jnp.einsum("...bi,ij,...bj->...b", jnp.conj(states), operator, states)
    return jnp.real(jnp.mean(vals, axis=-1))


def _densify(x):
    if x is None:
        return None
    if hasattr(x, "todense"):
        x = x.todense()
    elif hasattr(x, "toarray"):
        x = x.toarray()
    return jnp.asarray(x)


def solve_mc_trajectories(
    model,
    t_span,
    y0,
    n_traj: int,
    key=None,
    n_steps: int = 1000,
    n_save: int = 10,
    expm_order: int = 12,
    expm_squarings: int = 4,
    mesh=None,
    jump_placement: str = "interp",
    thresholds=None,
) -> MCResult:
    r"""Unravel a :class:`.LindbladModel` into ``n_traj`` quantum trajectories.

    Args:
        model: a non-vectorized :class:`.LindbladModel`. Hamiltonian /
            dissipator signals must be set for the corresponding operator
            groups (the model's own evaluation contract); dissipator rates
            must be nonnegative over the interval for the unraveling to be
            a probability process.
        t_span: ``(t0, tf)``.
        y0: ``(dim,)`` initial pure state (normalized internally).
        n_traj: number of trajectories (the lane batch).
        key: ``jax.random`` key (or int seed; default seed 0).
        n_steps: fixed midpoint-exponential steps over ``[t0, tf]``; must be
            divisible by ``n_save``.
        n_save: number of equally spaced save points after ``t0``.
        expm_order: Taylor order of the per-step propagator.
        expm_squarings: scaling-and-squaring count of the per-step
            propagator (raise for large ``||G_eff|| * dt``).
        mesh: optional ``jax.sharding.Mesh`` with a ``"data"`` axis — the
            trajectory lanes are sharded across it (a GSPMD sharding
            constraint on the lane axis; the shared per-step propagator
            replicates, jump selects stay lane-local, and the
            trajectory-average density reduces across chips). ``n_traj``
            must divide evenly across the axis.
        jump_placement: ``"interp"`` (default) places each jump at the
            log-interpolated norm-crossing time inside the step and evolves
            the post-jump remainder — second-order weak error; ``"end"``
            is the standard jump-at-step-boundary discretization,
            first-order in the jump placement (see the module docstring).
        thresholds: optional ``(n_traj,)`` initial waiting-time thresholds
            in (0, 1), replacing the uniform draw — use stratified values
            (e.g. ``(arange(N) + 0.5) / N``) for low-discrepancy variance
            reduction on the FIRST jump of each lane. Subsequent thresholds
            are always drawn from ``key``.

    Returns:
        :class:`MCResult`.
    """
    from .solver_utils import is_lindblad_model_not_vectorized

    if not is_lindblad_model_not_vectorized(model):
        raise DynamicsError(
            "solve_mc_trajectories requires a non-vectorized LindbladModel."
        )
    if n_steps % n_save != 0:
        raise DynamicsError("n_steps must be divisible by n_save.")
    if key is None:
        key = jax.random.PRNGKey(0)
    elif isinstance(key, int):
        key = jax.random.PRNGKey(key)

    coll = model._operator_collection
    frame = model.rotating_frame
    d = frame.frame_diag  # purely imaginary (dim,) or None

    # dissipators in the frame eigenbasis, static first (rate 1)
    L_list = []
    n_static = 0
    if coll.static_dissipators is not None:
        Ls = _densify(coll.static_dissipators)
        n_static = Ls.shape[0]
        L_list.append(Ls)
    if coll.dissipator_operators is not None:
        L_list.append(_densify(coll.dissipator_operators))
    L_all = jnp.concatenate(L_list, axis=0) if L_list else None
    M_all = (
        jnp.einsum("kji,kjl->kil", jnp.conj(L_all), L_all) if L_all is not None else None
    )
    n_chan = 0 if L_all is None else L_all.shape[0]

    t0, tf = float(t_span[0]), float(t_span[1])
    dt = (tf - t0) / n_steps
    dim = model.dim

    y0 = jnp.asarray(y0, dtype=complex)
    y0 = y0 / jnp.linalg.norm(y0)
    # lab -> rotating frame, frame basis: phi(t0) = e^{-t0 F} y0
    phi0 = frame.state_into_frame(t0, y0, return_in_frame_basis=True)
    phi0 = jnp.broadcast_to(phi0[:, None], (dim, n_traj)).astype(complex)

    # signal evaluation through the model's own contract (raises the
    # documented errors when a present operator group has no signals)
    def signal_values(t):
        return model._signal_values(t)

    # validate signal presence once, host-side, at t0
    signal_values(t0)

    has_ham = (
        coll.static_hamiltonian is not None or coll.hamiltonian_operators is not None
    )

    from ..ops.expm import expm_taylor

    def rates_at(t):
        _, dis_vals = signal_values(t)
        parts = []
        if n_static:
            parts.append(jnp.ones(n_static))
        if dis_vals is not None:
            parts.append(jnp.asarray(dis_vals, dtype=float))
        return jnp.concatenate(parts) if parts else None

    def effective_generator(t):
        A = jnp.zeros((dim, dim), dtype=complex)
        if has_ham:
            # the collection's static Hamiltonian is stored frame-SUBTRACTED
            # (H_fb - 1j d, the model-layer contract), so -1j * (.) is the
            # rotating-frame drift -iH_fb - d already
            ham_vals, _ = signal_values(t)
            A = -1j * jnp.asarray(coll.evaluate_hamiltonian(ham_vals))
        if n_chan:
            gam = rates_at(t)
            A = A - 0.5 * jnp.tensordot(gam, M_all, axes=1)
        if d is not None:
            # rotating-frame conjugation is an elementwise phase mask in the
            # frame eigenbasis; the diagonal (including the -d subtraction)
            # is mask-invariant
            P = jnp.exp((d[None, :] - d[:, None]) * t)
            A = A * P
        return A

    interp = jump_placement == "interp"
    if jump_placement not in ("interp", "end"):
        raise DynamicsError("jump_placement must be 'interp' or 'end'.")

    def step(carry, i):
        phi0_, r, k, jumps = carry
        t_start = t0 + i * dt
        t_mid = t0 + (i + 0.5) * dt
        t_end = t0 + (i + 1.0) * dt

        U = expm_taylor(
            effective_generator(t_mid) * dt, order=expm_order, squarings=expm_squarings
        )
        phi = U @ phi0_
        if n_chan:
            nrm2 = jnp.sum(jnp.abs(phi) ** 2, axis=0)
            do_jump = nrm2 < r
            if interp:
                # crossing time by log interpolation of the norm decay
                # (exact for a constant within-step rate, O(dt^2) otherwise)
                n0 = jnp.sum(jnp.abs(phi0_) ** 2, axis=0)
                ln0 = jnp.log(jnp.where(n0 > 0, n0, 1.0))
                ln1 = jnp.log(jnp.where(nrm2 > 0, nrm2, 1e-300))
                lnr = jnp.log(r)
                denom = ln0 - ln1
                frac = jnp.clip(
                    (ln0 - lnr) / jnp.where(denom > 0, denom, 1.0), 0.0, 1.0
                )  # (B,) crossing fraction of the step
                t_tau = t_start + frac * dt
                phi_tau = phi0_ + frac[None, :] * (phi - phi0_)
            else:
                t_tau = jnp.full((n_traj,), t_end)
                phi_tau = phi
            # candidates in the rotating frame: e^{-d t} L_k e^{d t} phi(t)
            chi = (
                phi_tau
                if d is None
                else jnp.exp(d[:, None] * t_tau[None, :]) * phi_tau
            )
            cand = jnp.einsum("kij,jb->kib", L_all, chi)  # (K, n, B)
            w = jnp.sum(jnp.abs(cand) ** 2, axis=1)  # (K, B)
            gam = rates_at(t_end)
            w = w * gam[:, None]
            wsum = jnp.sum(w, axis=0)
            cdf = jnp.cumsum(w, axis=0) / jnp.where(wsum > 0, wsum, 1.0)
            k, k_sel, k_new = jax.random.split(k, 3)
            u = jax.random.uniform(k_sel, (n_traj,))
            chan = jnp.argmax(cdf >= u[None, :], axis=0)  # (B,)
            c_sel = jnp.take_along_axis(cand, chan[None, None, :], axis=0)[0]
            c_nrm = jnp.sqrt(jnp.sum(jnp.abs(c_sel) ** 2, axis=0))
            c_sel = c_sel / jnp.where(c_nrm > 0, c_nrm, 1.0)
            if d is not None:
                c_sel = jnp.exp(-d[:, None] * t_tau[None, :]) * c_sel
            if interp:
                # post-jump remainder evolution: c + theta (Uc - c), the
                # linear fraction of the shared step propagator
                Uc = U @ c_sel
                c_sel = c_sel + (1.0 - frac)[None, :] * (Uc - c_sel)
            # never jump on a zero-weight lane (fully decayed channel set)
            do_jump = do_jump & (wsum > 0)
            phi = jnp.where(do_jump[None, :], c_sel, phi)
            r = jnp.where(do_jump, jax.random.uniform(k_new, (n_traj,)), r)
            jumps = jumps + do_jump.astype(jnp.int32)
        return (phi, r, k, jumps), None

    steps_per_save = n_steps // n_save

    def segment(carry, s):
        idx = s * steps_per_save + jnp.arange(steps_per_save)
        carry, _ = jax.lax.scan(step, carry, idx)
        phi = carry[0]
        nrm = jnp.linalg.norm(phi, axis=0)
        return carry, phi / jnp.where(nrm > 0, nrm, 1.0)

    key, k_r = jax.random.split(key)
    if thresholds is not None:
        r0 = jnp.asarray(thresholds, dtype=float)
        if r0.shape != (n_traj,):
            raise DynamicsError("thresholds must have shape (n_traj,).")
    else:
        r0 = jax.random.uniform(k_r, (n_traj,))
    jumps0 = jnp.zeros(n_traj, dtype=jnp.int32)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _P
        from ..parallel import DATA_AXIS

        lane = NamedSharding(mesh, _P(None, DATA_AXIS))
        vec = NamedSharding(mesh, _P(DATA_AXIS))
        phi0 = jax.lax.with_sharding_constraint(phi0, lane)
        r0 = jax.lax.with_sharding_constraint(r0, vec)
        jumps0 = jax.lax.with_sharding_constraint(jumps0, vec)
    carry0 = (phi0, r0, key, jumps0)
    carry, saved = jax.lax.scan(segment, carry0, jnp.arange(n_save))

    times = t0 + (tf - t0) * jnp.arange(n_save + 1) / n_save
    saved = jnp.concatenate([phi0[None] / jnp.linalg.norm(y0), saved], axis=0)

    # frame basis -> original basis; states stay IN the rotating frame
    # (the package-wide Solver.solve convention — apply
    # rotating_frame.state_out_of_frame(t, y) for lab-frame states)
    states_rf = jax.vmap(frame.state_out_of_frame_basis)(saved)  # (S+1, dim, B)
    states = jnp.swapaxes(states_rf, -1, -2)  # (S+1, B, dim)
    density = jnp.einsum("sbi,sbj->sij", states, jnp.conj(states)) / n_traj
    return MCResult(
        t=times, states=states, density=density, jump_counts=carry[3]
    )


def _normalize_sweep_signals(sigs):
    """signals_fn output -> (ham SignalList | None, dis SignalList | None)."""
    from ..signals import SignalList

    if isinstance(sigs, tuple) and len(sigs) == 2:
        ham, dis = sigs
    else:
        ham, dis = sigs, None

    def to_list(x):
        if x is None:
            return None
        if isinstance(x, SignalList):
            return x
        return SignalList(list(x))

    return to_list(ham), to_list(dis)


def solve_mc_trajectories_sweep(
    model,
    t_span,
    y0,
    signals_fn,
    params,
    n_traj: int,
    key=None,
    n_steps: int = 1000,
    n_save: int = 10,
    expm_order: int = 12,
    expm_squarings: int = 4,
    mesh=None,
    jump_placement: str = "interp",
    thresholds=None,
) -> MCResult:
    r"""Trajectory unraveling over a parameter sweep — the MC member of the
    repo's sweep-solver family (``fused_sweep_solve``, perturbative
    ``solve_sweep``, ...).

    Structure: rather than vmapping the single-member solver (which would
    re-exponentiate small per-member matrices every step), ALL ``n_steps x
    n_members`` effective-generator exponentials are computed up front in
    ONE batched Taylor expm (:func:`.ops.expm.expm_taylor`), and the stochastic
    evolution is one lockstep ``lax.scan`` over steps with member-batched
    ``(M, n, n) @ (M, n, B)`` propagator applies and per-(member, lane)
    jump selects.

    Args:
        model: non-vectorized :class:`.LindbladModel`. The model's OWN
            signals are ignored; per-member signals come from
            ``signals_fn``.
        t_span: ``(t0, tf)``.
        y0: ``(dim,)`` initial pure state, shared across members.
        signals_fn: maps one parameter pytree to either a Hamiltonian
            signal list, or a ``(hamiltonian_signals, dissipator_signals)``
            tuple (matching the model's operator groups).
        params: batched parameters (leading axis = sweep axis, length M).
        n_traj: trajectories PER member.
        key, n_steps, n_save, expm_order, expm_squarings: as in
            :func:`solve_mc_trajectories`.
        mesh: optional mesh with a ``"data"`` axis — members are sharded
            across it (embarrassingly parallel).
        jump_placement: ``"interp"`` (second-order, default) or ``"end"``
            — as in :func:`solve_mc_trajectories`.
        thresholds: optional ``(M, n_traj)`` initial waiting-time
            thresholds replacing the uniform draw (stratified sampling).

    Returns:
        :class:`MCResult` with a member axis:
        ``states (n_save+1, M, n_traj, dim)``,
        ``density (n_save+1, M, dim, dim)``, ``jump_counts (M, n_traj)``.
    """
    from .solver_utils import is_lindblad_model_not_vectorized
    from ..ops.expm import expm_taylor

    if not is_lindblad_model_not_vectorized(model):
        raise DynamicsError(
            "solve_mc_trajectories_sweep requires a non-vectorized LindbladModel."
        )
    if n_steps % n_save != 0:
        raise DynamicsError("n_steps must be divisible by n_save.")
    if key is None:
        key = jax.random.PRNGKey(0)
    elif isinstance(key, int):
        key = jax.random.PRNGKey(key)

    coll = model._operator_collection
    frame = model.rotating_frame
    d = frame.frame_diag

    L_list = []
    n_static = 0
    if coll.static_dissipators is not None:
        Ls = _densify(coll.static_dissipators)
        n_static = Ls.shape[0]
        L_list.append(Ls)
    if coll.dissipator_operators is not None:
        L_list.append(_densify(coll.dissipator_operators))
    L_all = jnp.concatenate(L_list, axis=0) if L_list else None
    M_ops = (
        jnp.einsum("kji,kjl->kil", jnp.conj(L_all), L_all) if L_all is not None else None
    )
    n_chan = 0 if L_all is None else L_all.shape[0]

    t0, tf = float(t_span[0]), float(t_span[1])
    dt = (tf - t0) / n_steps
    dim = model.dim
    params = jax.tree_util.tree_map(jnp.asarray, params)
    n_members = jax.tree_util.tree_leaves(params)[0].shape[0]

    has_ham_ops = coll.hamiltonian_operators is not None
    has_dis_ops = coll.dissipator_operators is not None
    has_ham = coll.static_hamiltonian is not None or has_ham_ops

    # validate the signals_fn contract once, host-side
    ham0, dis0 = _normalize_sweep_signals(
        signals_fn(jax.tree_util.tree_map(lambda x: x[0], params))
    )
    if has_ham_ops and ham0 is None:
        raise DynamicsError(
            "signals_fn must supply Hamiltonian signals (model has "
            "hamiltonian_operators)."
        )
    if has_dis_ops and dis0 is None:
        raise DynamicsError(
            "signals_fn must supply dissipator signals (model has "
            "dissipator_operators)."
        )

    t_mid = t0 + (jnp.arange(n_steps) + 0.5) * dt
    t_end = t0 + (jnp.arange(n_steps) + 1.0) * dt

    def member_vals(p, which):
        ham, dis = _normalize_sweep_signals(signals_fn(p))
        sigs = ham if which == "ham" else dis

        def at(t):
            return jnp.asarray(sigs(t))

        return jax.vmap(at)(t_mid if which == "ham" else t_end)

    ham_vals = (
        jax.vmap(lambda p: member_vals(p, "ham"))(params) if has_ham_ops else None
    )  # (M, T, k_h)

    def rates_of(p):
        parts = []
        if n_static:
            parts.append(jnp.ones((n_steps, n_static)))
        if has_dis_ops:
            parts.append(member_vals(p, "dis"))
        return jnp.concatenate(parts, axis=-1) if parts else None

    gammas = jax.vmap(rates_of)(params) if n_chan else None  # (M, T, K)
    # dissipator decay uses midpoint rates; jump weights use endpoint rates
    if n_chan:
        def rates_mid(p):
            parts = []
            if n_static:
                parts.append(jnp.ones((n_steps, n_static)))
            if has_dis_ops:
                ham_, dis_ = _normalize_sweep_signals(signals_fn(p))
                parts.append(jax.vmap(lambda t: jnp.asarray(dis_(t)))(t_mid))
            return jnp.concatenate(parts, axis=-1)

        gammas_mid = jax.vmap(rates_mid)(params)  # (M, T, K)

    # ---- precompute ALL (T, M) step propagators in one batched expm -------
    def drift_at(m_vals_t):
        if has_ham:
            return -1j * jnp.asarray(coll.evaluate_hamiltonian(m_vals_t))
        return jnp.zeros((dim, dim), dtype=complex)

    if has_ham_ops:
        A = jax.vmap(jax.vmap(drift_at))(ham_vals)  # (M, T, n, n)
    else:
        A = jnp.broadcast_to(drift_at(None), (n_members, n_steps, dim, dim))
    if n_chan:
        A = A - 0.5 * jnp.einsum("mtk,kij->mtij", gammas_mid, M_ops)
    if d is not None:
        P = jnp.exp((d[None, :] - d[:, None])[None, :, :] * t_mid[:, None, None])
        A = A * P[None]  # (M, T, n, n)

    U = expm_taylor(
        jnp.swapaxes(A, 0, 1) * dt, order=expm_order, squarings=expm_squarings
    )  # (T, M, n, n)

    phase_end = None if d is None else jnp.exp(d[None, :] * t_end[:, None])  # (T, n)

    y0 = jnp.asarray(y0, dtype=complex)
    y0 = y0 / jnp.linalg.norm(y0)
    phi0 = frame.state_into_frame(t0, y0, return_in_frame_basis=True)
    phi0 = jnp.broadcast_to(
        phi0[None, :, None], (n_members, dim, n_traj)
    ).astype(complex)

    interp = jump_placement == "interp"
    if jump_placement not in ("interp", "end"):
        raise DynamicsError("jump_placement must be 'interp' or 'end'.")

    def step(carry, inputs):
        phi0_, r, k, jumps = carry
        if n_chan:
            U_t, pe, gam_t, t_s = inputs  # (M,n,n), (n,), (M,K), ()
        else:
            U_t = inputs[0] if isinstance(inputs, tuple) else inputs
        phi = jnp.einsum("mij,mjb->mib", U_t, phi0_)
        if n_chan:
            nrm2 = jnp.sum(jnp.abs(phi) ** 2, axis=1)  # (M, B)
            do_jump = nrm2 < r
            if interp:
                # second-order jump placement (see solve_mc_trajectories)
                n0 = jnp.sum(jnp.abs(phi0_) ** 2, axis=1)
                ln0 = jnp.log(jnp.where(n0 > 0, n0, 1.0))
                ln1 = jnp.log(jnp.where(nrm2 > 0, nrm2, 1e-300))
                denom = ln0 - ln1
                frac = jnp.clip(
                    (ln0 - jnp.log(r)) / jnp.where(denom > 0, denom, 1.0), 0.0, 1.0
                )  # (M, B)
                t_tau = t_s + frac * dt
                phi_tau = phi0_ + frac[:, None, :] * (phi - phi0_)
                chi = (
                    phi_tau
                    if d is None
                    else jnp.exp(d[None, :, None] * t_tau[:, None, :]) * phi_tau
                )
            else:
                phi_tau = phi
                chi = phi if d is None else pe[None, :, None] * phi
            cand = jnp.einsum("kij,mjb->kmib", L_all, chi)  # (K, M, n, B)
            w = jnp.sum(jnp.abs(cand) ** 2, axis=2)  # (K, M, B)
            w = w * jnp.swapaxes(gam_t, 0, 1)[:, :, None]  # (K, M, B)
            wsum = jnp.sum(w, axis=0)
            cdf = jnp.cumsum(w, axis=0) / jnp.where(wsum > 0, wsum, 1.0)
            k, k_sel, k_new = jax.random.split(k, 3)
            u = jax.random.uniform(k_sel, (n_members, n_traj))
            chan = jnp.argmax(cdf >= u[None], axis=0)  # (M, B)
            c_sel = jnp.take_along_axis(cand, chan[None, :, None, :], axis=0)[0]
            c_nrm = jnp.sqrt(jnp.sum(jnp.abs(c_sel) ** 2, axis=1))  # (M, B)
            c_sel = c_sel / jnp.where(c_nrm > 0, c_nrm, 1.0)[:, None, :]
            if d is not None:
                if interp:
                    c_sel = jnp.exp(-d[None, :, None] * t_tau[:, None, :]) * c_sel
                else:
                    c_sel = jnp.conj(pe)[None, :, None] * c_sel
            if interp:
                # post-jump remainder: c + theta (Uc - c)
                Uc = jnp.einsum("mij,mjb->mib", U_t, c_sel)
                c_sel = c_sel + (1.0 - frac)[:, None, :] * (Uc - c_sel)
            do_jump = do_jump & (wsum > 0)
            phi = jnp.where(do_jump[:, None, :], c_sel, phi)
            r = jnp.where(do_jump, jax.random.uniform(k_new, (n_members, n_traj)), r)
            jumps = jumps + do_jump.astype(jnp.int32)
        return (phi, r, k, jumps), None

    steps_per_save = n_steps // n_save
    Useg = U.reshape(n_save, steps_per_save, n_members, dim, dim)
    if n_chan:
        pe_seg = phase_end if phase_end is not None else jnp.ones((n_steps, dim))
        pe_seg = pe_seg.reshape(n_save, steps_per_save, dim)
        gam_seg = jnp.swapaxes(gammas, 0, 1).reshape(
            n_save, steps_per_save, n_members, n_chan
        )
        ts_seg = (t0 + jnp.arange(n_steps) * dt).reshape(n_save, steps_per_save)
        seg_inputs = (Useg, pe_seg, gam_seg, ts_seg)
    else:
        seg_inputs = (Useg,)

    def segment(carry, inputs):
        carry, _ = jax.lax.scan(step, carry, inputs)
        phi = carry[0]
        nrm = jnp.linalg.norm(phi, axis=1, keepdims=True)
        return carry, phi / jnp.where(nrm > 0, nrm, 1.0)

    key, k_r = jax.random.split(key)
    if thresholds is not None:
        r0 = jnp.asarray(thresholds, dtype=float)
        if r0.shape != (n_members, n_traj):
            raise DynamicsError("thresholds must have shape (n_members, n_traj).")
    else:
        r0 = jax.random.uniform(k_r, (n_members, n_traj))
    jumps0 = jnp.zeros((n_members, n_traj), dtype=jnp.int32)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _P
        from ..parallel import DATA_AXIS

        mem3 = NamedSharding(mesh, _P(DATA_AXIS, None, None))
        mem2 = NamedSharding(mesh, _P(DATA_AXIS, None))
        phi0 = jax.lax.with_sharding_constraint(phi0, mem3)
        r0 = jax.lax.with_sharding_constraint(r0, mem2)
        jumps0 = jax.lax.with_sharding_constraint(jumps0, mem2)
    carry0 = (phi0, r0, key, jumps0)
    carry, saved = jax.lax.scan(segment, carry0, seg_inputs)
    # saved: (S, M, n, B)

    times = t0 + (tf - t0) * jnp.arange(n_save + 1) / n_save
    saved = jnp.concatenate([phi0[None], saved], axis=0)

    # frame basis -> original basis; rotating-frame convention as in the
    # single-member solver
    states_rf = jax.vmap(jax.vmap(frame.state_out_of_frame_basis))(saved)
    states = jnp.swapaxes(states_rf, -1, -2)  # (S+1, M, B, n)
    density = jnp.einsum("smbi,smbj->smij", states, jnp.conj(states)) / n_traj
    return MCResult(t=times, states=states, density=density, jump_counts=carry[3])
