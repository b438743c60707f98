r"""Double-float32 fixed-step Magnus sweep: 1e-8-class accuracy from f32.

High-precision counterpart of :func:`.xla_sweep.sweep_expm_magnus2_xla` in
float32 arithmetic. Same math — per step, assemble the
frame-basis generator at the Gauss-Legendre nodes, combine with the Magnus
order-4 (two-node) or order-6 (three-node) commutator rule (same rules as
``solvers/fixed_step_solvers.py``), exponentiate, apply to the state — but the
accuracy-critical operations run in compensated double-float32 (:mod:`.df32`,
unit roundoff ~2^-48), so a few-hundred-step propagator chain keeps ~1e-12
arithmetic accuracy instead of the plain engine's ~1e-6 f32 floor.

The design exploits that fixed-step grids make every evaluation time known
at trace time: ALL transcendental values (frame phases ``exp(i omega tau)``)
are computed on host in float64 and shipped as df tables, so device code
needs only +,-,* — exactly the operations df32 makes accurate. Signal
coefficients are likewise evaluated on host in float64 (the glue in
``solvers/fused_sweep.py`` does this; it requires concrete sweep
parameters).

Mixed precision (on by default): in the order-6 rule the
three commutators enter ``M`` only through terms that are O(dt^2-dt^3)
RELATIVE corrections to the leading ``a1`` term — plain-f32 evaluation of the
commutators therefore contributes ~``2^-24 * dt^2`` relative error per step,
below the 1e-8 target for the usual dt, while costing 25x less than df
matmuls (``fast_commutators``). Similarly the outer (high-``j``) Horner
iterations of ``expm(M) y`` are damped by ``|M|^j / j!`` and run in f32, with
only the final ``horner_df_tail`` iterations in df. Both knobs are exposed
and the conservative full-df path remains available.

The time grid may be NON-UNIFORM: ``dt`` accepts a per-step array, enabling
the host-side adaptive grid builder in ``solvers/fused_sweep.py``
(``df_grid="adaptive"``) to concentrate steps where the generator actually
varies.

Layout is batch-on-lanes ``(n, n, B)`` like the Pallas kernels, but as
straight-line jnp code (XLA fuses the elementwise df chains); the expm is
applied as Horner mat-VEC Taylor — the propagator itself is never formed,
saving an O(n) factor.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import df32
from .xla_sweep import _GAUSS_C1, _GAUSS_C2, _P2

__all__ = ["sweep_expm_magnus_df", "MAGNUS_NODES"]


def _dfi(x, idx):
    """Index a df pair."""
    return x[0][idx], x[1][idx]


def _ci(z, idx):
    """Index a complex df value."""
    return _dfi(z[0], idx), _dfi(z[1], idx)


def _ctree_sum(z, axis: int):
    """Sum a complex df array over ``axis`` by pairwise (tree) reduction.

    Pairwise compensated adds keep the error O(log n * eps^2) AND keep the
    traced graph log-depth — an unrolled sequential loop made XLA compile
    times explode (the whole point of this formulation)."""

    def take(x, sl):
        idx = (slice(None),) * axis + (sl,)
        return x[idx]

    size = z[0][0].shape[axis]
    while size > 1:
        half = size // 2
        a = jax.tree_util.tree_map(lambda x: take(x, slice(0, half)), z)
        b = jax.tree_util.tree_map(lambda x: take(x, slice(half, 2 * half)), z)
        s = df32.cadd(a, b)
        if size % 2:
            rest = jax.tree_util.tree_map(lambda x: take(x, slice(2 * half, size)), z)
            s = jax.tree_util.tree_map(
                lambda u, v: jnp.concatenate([u, v], axis=axis), s, rest
            )
        z = s
        size = half + size % 2
    return jax.tree_util.tree_map(lambda x: jnp.squeeze(x, axis=axis), z)


def _cmatmul(a, b, n: int):
    """(n, n, B) @ (n, n, B) complex df, batch on lanes.

    One broadcast df multiply into (n, m, n, B) + a tree-sum over m —
    O(n^3 B) flops but only ~tens of traced ops."""
    term = df32.cmul(_ci(a, (slice(None), slice(None), None)), _ci(b, (None,)))
    return _ctree_sum(term, axis=1)


def _cmatvec(a, v, n: int):
    """(n, n, B) @ (n, B) complex df."""
    term = df32.cmul(a, _ci(v, (None,)))
    return _ctree_sum(term, axis=1)


def _flatten_c(z):
    return (z[0][0], z[0][1], z[1][0], z[1][1])


def _unflatten_c(t):
    return ((t[0], t[1]), (t[2], t[3]))


def _ccomm(a, b, n):
    """Commutator [a, b] of (n, n, B) complex df matrices."""
    return df32.csub(_cmatmul(a, b, n), _cmatmul(b, a, n))


def _ccomm_anti(a, b, n):
    """[a, b] for ANTI-HERMITIAN ``a``, ``b`` — one matmul instead of two:
    ``(AB)^dagger = B^dagger A^dagger = BA``, so ``[A, B] = C - C^dagger``
    with ``C = AB``. (Commutators of anti-Hermitian matrices are again
    anti-Hermitian, so every commutator in the Magnus rules qualifies when
    the generators do.)"""
    c_re, c_im = _cmatmul(a, b, n)
    t = lambda x: (jnp.swapaxes(x[0], 0, 1), jnp.swapaxes(x[1], 0, 1))
    return df32.sub(c_re, t(c_re)), df32.add(c_im, t(c_im))


# ---------------------------------------------------------------------------
# plain-complex64 helpers for the mixed-precision fast paths


def _c64(z):
    """Complex df -> complex64 view (hi parts)."""
    return jax.lax.complex(z[0][0], z[1][0])


def _cfrom32(z32):
    """complex64 -> complex df with zero lo."""
    re = jnp.real(z32)
    im = jnp.imag(z32)
    return (re, jnp.zeros_like(re)), (im, jnp.zeros_like(im))


def _matmul32(a, b):
    """(n, n, B) @ (n, n, B) complex64, batch on lanes."""
    return jnp.einsum("imb,mjb->ijb", a, b)


def _comm32(a, b, hermitian):
    if hermitian:
        c = _matmul32(a, b)
        return c - jnp.conj(jnp.swapaxes(c, 0, 1))
    return _matmul32(a, b) - _matmul32(b, a)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n", "k", "order", "magnus_order", "hermitian", "fast_commutators",
        "horner_df_tail", "coef_const", "eval_slots",
    ),
)
def _df_scan(
    n, k, order, magnus_order, stat, ops, phases, coefs, y0, consts,
    step_consts,
    hermitian=False,
    fast_commutators=True,
    coef_const=False,
    horner_df_tail=6,
    eval_slots=None,
):
    """The jitted df32 time loop.

    Args:
        stat: complex df (n, n) static generator.
        ops: complex df (k, n, n) operators.
        phases: (cos, sin) df pair tables, each (T, n_nodes, n, n).
        coefs: real df (T, n_nodes, k, B) signal values at the Gauss points.
        y0: complex df (n, B).
        consts: dt-free rule scalars: ``(two, twenty, inv12, inv60, inv240,
            inv_j)`` for order 3, ``(inv_j,)`` for order 2 (df pairs;
            ``inv_j`` shaped (order,)).
        step_consts: per-step df (T,) arrays of the dt-dependent rule
            scalars: order 3 ``(dt, c0*dt, c1*dt)``, order 2
            ``(dt/2, p2*dt^2)``.
        fast_commutators: (order 3 only) evaluate the three Magnus
            commutators in plain complex64 — they enter M only as
            O(dt^2)-relative corrections, so f32 keeps ~1e-9-class per-step
            accuracy at 25x less commutator cost.
        horner_df_tail: run Horner iterations with ``j > horner_df_tail`` in
            complex64 (their error is damped by ``|M|^j / j!``); the final
            ``horner_df_tail`` iterations run in df. 0 disables (full df).
    """
    inv_j = consts[-1]
    comm = _ccomm_anti if hermitian else _ccomm

    def build_generator(c_g, cos_g, sin_g):
        # static + sum_j c_j ops_j, then Hadamard frame rotation; shapes
        # broadcast (n, n, 1) x (1, 1, B) -> (n, n, B)
        acc_re = _dfi(stat[0], (Ellipsis, None))
        acc_im = _dfi(stat[1], (Ellipsis, None))
        for j in range(k):
            c = _dfi(c_g, (j, None, None))  # (1, 1, B)
            op_re = _dfi(ops[0], (j, Ellipsis, None))
            op_im = _dfi(ops[1], (j, Ellipsis, None))
            acc_re = df32.add(acc_re, df32.mul(op_re, c))
            acc_im = df32.add(acc_im, df32.mul(op_im, c))
        cos_b = _dfi(cos_g, (Ellipsis, None))
        sin_b = _dfi(sin_g, (Ellipsis, None))
        g_re = df32.sub(df32.mul(acc_re, cos_b), df32.mul(acc_im, sin_b))
        g_im = df32.add(df32.mul(acc_re, sin_b), df32.mul(acc_im, cos_b))
        return g_re, g_im

    n_step_consts = len(step_consts)

    def step(carry, xs):
        y = _unflatten_c(carry)
        c_hi, c_lo, cos_hi, cos_lo, sin_hi, sin_lo = xs[:6]
        sc = [
            (xs[6 + 2 * i], xs[6 + 2 * i + 1]) for i in range(n_step_consts)
        ]  # per-step df scalars
        g = [
            build_generator(
                (c_hi[i], c_lo[i]), (cos_hi[i], cos_lo[i]), (sin_hi[i], sin_lo[i])
            )
            for i in range(c_hi.shape[0])
        ]

        if magnus_order == 2:
            # M = (dt/2)(G1 + G2) + p2 dt^2 [G2, G1]
            half_dt, p2_dt2 = sc
            m_op = df32.cadd(
                df32.cmul_real(df32.cadd(g[0], g[1]), half_dt),
                df32.cmul_real(comm(g[1], g[0], n), p2_dt2),
            )
        else:
            # order-6 rule (Blanes et al. 2009; same combination as
            # solvers/fixed_step_solvers.py get_exponential_take_step order 3)
            dt_c, c0dt, c1dt = sc
            two, twenty, inv12, inv60, inv240 = consts[:5]
            a1 = df32.cmul_real(g[1], dt_c)
            a2 = df32.cmul_real(df32.csub(g[2], g[0]), c0dt)
            a3 = df32.cmul_real(
                df32.cadd(df32.csub(g[2], g[1]), df32.csub(g[0], g[1])), c1dt
            )
            if fast_commutators:
                # all three commutators in complex64: they reach M only
                # through the (1/240)[left, right] term, an O(dt^2)-relative
                # correction — f32 error lands at ~2^-24 * dt^2 per step
                a1_32, a2_32, a3_32 = _c64(a1), _c64(a2), _c64(a3)
                comm1 = _comm32(a1_32, a2_32, hermitian)
                comm2 = _comm32(2.0 * a3_32 + comm1, a1_32, hermitian) / 60.0
                left = comm1 - (20.0 * a1_32 + a3_32)
                right = a2_32 + comm2
                outer = _comm32(left, right, hermitian) / 240.0
                m_op = df32.cadd(
                    df32.cadd(a1, df32.cmul_real(a3, inv12)), _cfrom32(outer)
                )
            else:
                comm1 = comm(a1, a2, n)
                comm2 = df32.cmul_real(
                    comm(df32.cadd(df32.cmul_real(a3, two), comm1), a1, n), inv60
                )
                left = df32.csub(comm1, df32.cadd(df32.cmul_real(a1, twenty), a3))
                right = df32.cadd(a2, comm2)
                m_op = df32.cadd(
                    df32.cadd(a1, df32.cmul_real(a3, inv12)),
                    df32.cmul_real(comm(left, right, n), inv240),
                )

        # y <- expm(M) y, Horner mat-vec Taylor:
        # v = y; for j = order..1: v = y + (M v) / j
        # Outer iterations (j > horner_df_tail) in complex64 — their error is
        # damped by |M|^j / j! before reaching the result; the final
        # iterations run in df (fori_loop keeps the traced graph small).
        tail = order
        v = y
        if 0 < horner_df_tail < order:
            tail = horner_df_tail
            m32 = _c64(m_op)
            y32 = _c64(y)
            v32 = y32
            for j in range(order, tail, -1):
                v32 = y32 + jnp.einsum("ijb,jb->ib", m32, v32) / j
            v = _cfrom32(v32)

        def horner(i, v_flat):
            vv = _unflatten_c(v_flat)
            mv = _cmatvec(m_op, vv, n)
            inv = _dfi(inv_j, tail - 1 - i)
            return _flatten_c(df32.cadd(y, df32.cmul_real(mv, inv)))

        v = _unflatten_c(jax.lax.fori_loop(0, tail, horner, _flatten_c(v)))
        return _flatten_c(v), None

    if coef_const:
        # constant-envelope fast path: ``coefs`` arrived as the compact
        # (k, B) hi/lo pair — broadcast to the full per-step table ON DEVICE
        # (shipping (T, n_nodes, k, B) from the host per call would
        # otherwise dominate the whole solve)
        T_steps = step_consts[0][0].shape[0]
        nn = len(MAGNUS_NODES[magnus_order])
        full_shape = (T_steps, nn) + coefs[0].shape
        coefs = (
            jnp.broadcast_to(coefs[0][None, None], full_shape),
            jnp.broadcast_to(coefs[1][None, None], full_shape),
        )
    xs = (
        coefs[0], coefs[1], phases[0][0], phases[0][1], phases[1][0], phases[1][1],
    ) + tuple(x for pair in step_consts for x in pair)
    if eval_slots is None:
        out, _ = jax.lax.scan(step, _flatten_c(y0), xs)
        return out

    # trajectory variant: after step j, store the state into slot
    # eval_slots[j] of an (n_eval + 1)-deep buffer (slot -1 writes the
    # sacrificial extra row — branch-free)
    n_eval = max(eval_slots) + 1
    slots = jnp.asarray(np.asarray(eval_slots, dtype=np.int32))
    bufs = tuple(
        jnp.zeros((n_eval + 1,) + y0[0][0].shape, dtype=jnp.float32)
        for _ in range(4)
    )

    def step_traj(carry, xs_t):
        xs_core, slot = xs_t
        new_y, _ = step(carry[:4], xs_core)
        slot_safe = jnp.where(slot >= 0, slot, n_eval)
        new_bufs = tuple(
            b.at[slot_safe].set(v) for b, v in zip(carry[4:], new_y)
        )
        return new_y + new_bufs, None

    out, _ = jax.lax.scan(step_traj, _flatten_c(y0) + bufs, (xs, slots))
    return out[:4], tuple(b[:n_eval] for b in out[4:])


#: Gauss-Legendre nodes used per magnus_order
MAGNUS_NODES = {
    2: np.array([_GAUSS_C1, _GAUSS_C2]),
    3: np.array([0.5 - np.sqrt(15) / 10, 0.5, 0.5 + np.sqrt(15) / 10]),
}


def _rule_consts(magnus_order: int, order: int):
    """dt-free df scalar tables for the step rule + expm Horner."""
    inv_j = df32.from_f64(1.0 / np.arange(1, order + 1, dtype=np.float64))
    if magnus_order == 2:
        return (inv_j,)
    return (
        df32.from_f64(2.0),
        df32.from_f64(20.0),
        df32.from_f64(1.0 / 12),
        df32.from_f64(1.0 / 60),
        df32.from_f64(1.0 / 240),
        inv_j,
    )


def _step_consts(magnus_order: int, dts: np.ndarray):
    """Per-step df (T,) arrays of the dt-dependent rule scalars."""
    dts = np.asarray(dts, dtype=np.float64)
    if magnus_order == 2:
        return (df32.from_f64(dts / 2), df32.from_f64(_P2 * dts**2))
    return (
        df32.from_f64(dts),
        df32.from_f64(np.sqrt(15.0) / 3 * dts),
        df32.from_f64(10.0 / 3 * dts),
    )


@jax.jit
def _frame_phases_from_diag(cv, sv):
    """(n, n) frame phase tables from (T, n_nodes, n) diagonal phasors.

    ``e^{i omega_ij tau} = e^{i v_j tau} * conj(e^{i v_i tau})`` for
    ``omega_ij = v_j - v_i``, so with ``cv/sv`` the df pairs of
    ``cos/sin(v tau)``:

    ``cos(omega_ij tau) = c_j c_i + s_j s_i``
    ``sin(omega_ij tau) = s_j c_i - c_j s_i``

    All products/sums run in df32 (~2^-47 relative on values in [-1, 1] —
    absolute ~1e-14, same class as the host-f64 tables they replace).
    Returns ``(cos_pair, sin_pair)``, each (T, n_nodes, n, n).
    """
    ci = (cv[0][..., :, None], cv[1][..., :, None])
    cj = (cv[0][..., None, :], cv[1][..., None, :])
    si = (sv[0][..., :, None], sv[1][..., :, None])
    sj = (sv[0][..., None, :], sv[1][..., None, :])
    cos_m = df32.add(df32.mul(cj, ci), df32.mul(sj, si))
    sin_m = df32.sub(df32.mul(sj, ci), df32.mul(cj, si))
    return cos_m, sin_m


@functools.partial(jax.jit, static_argnames=("n_terms",))
def _combine_factor_table(cos_t, sin_t, a_re, a_im, n_terms):
    """On-device df32 assembly of the coefficient table from factors.

    ``c[t, node, j, b] = Re[A_jb e^{i theta_j(t)}]
                       = sum_r A_re[j,r,b] cos(theta_jr) - A_im[j,r,b] sin(theta_jr)``

    Args:
        cos_t, sin_t: df pairs (T, n_nodes, k, R) of the carrier phases at
            the Gauss times (host-f64 trig, split exactly).
        a_re, a_im: df pairs (k, R, Bc) of the member amplitudes.
        n_terms: R (static; the python loop below unrolls over it).

    Returns:
        df pair (T, n_nodes, k, Bc). All products/sums run in df32
        arithmetic (~2^-48 relative), so the table matches the host-f64
        reference to df roundoff.
    """
    acc = None
    for r in range(n_terms):
        c_r = (cos_t[0][..., r][..., None], cos_t[1][..., r][..., None])
        s_r = (sin_t[0][..., r][..., None], sin_t[1][..., r][..., None])
        ar = (a_re[0][:, r][None, None], a_re[1][:, r][None, None])
        ai = (a_im[0][:, r][None, None], a_im[1][:, r][None, None])
        term = df32.sub(df32.mul(c_r, ar), df32.mul(s_r, ai))
        acc = term if acc is None else df32.add(acc, term)
    return acc


def sweep_expm_magnus_df(
    static_op,
    operators,
    frame_omega,
    coefficients,
    y0,
    dt,
    t0: float = 0.0,
    magnus_order: int = 3,
    order: int = 12,
    chunk_b: int = 2048,
    hermitian: bool = False,
    fast_commutators: bool = True,
    horner_df_tail: int = 6,
    coef_factors=None,
    devices=None,
    eval_slots=None,
):
    r"""Fixed-step Magnus sweep (order 2 or 3 rule) in double-float32.

    Host-facing: all array arguments are host float64/complex128 numpy; the
    result is complex128 on host (the df pair is recombined in f64 — a
    complex64 return would clip the answer back to f32 at the boundary).

    Args:
        static_op: (n, n) complex static generator (frame basis, diag
            removed).
        operators: (k, n, n) complex signal operators (frame basis).
        frame_omega: (n, n) real frame frequency-difference matrix.
        coefficients: (T, n_nodes, k, B) float64 real signal values at the
            Gauss-Legendre nodes of every step (absolute times
            ``t_start[step] + MAGNUS_NODES[magnus_order] * dt[step]``).
        y0: (n, B) complex initial states (frame basis).
        dt: step size — a scalar (uniform grid) or a (T,) array of per-step
            sizes (e.g. from the host-adaptive grid builder).
        t0: initial time (frame phases use absolute time).
        magnus_order: 2 (two-node, 4th-order rule) or 3 (three-node,
            6th-order rule — ~2.5x the per-step cost, vastly fewer steps at
            1e-8 accuracy; the default).
        order: Taylor order of the expm mat-vec (12 gives ~1e-13 for
            ``|M| <~ 0.5``).
        chunk_b: sweep members per device dispatch (bounds the (n, n, B)
            df temporaries and the on-device table size).
        hermitian: the generators are anti-Hermitian (``G = -iH``) — every
            Magnus commutator then costs ONE matmul instead of two
            (see ``_ccomm_anti``; caller must guarantee the property).
        fast_commutators: (order 3) run the Magnus commutators in plain
            complex64 (O(dt^2)-relative terms; see the module docstring).
        horner_df_tail: Horner iterations with ``j`` above this run in
            complex64; 0 = full df.
        coef_factors: optional ``(A, carriers)`` FACTORIZED coefficients for
            constant-envelope sweeps — ``A`` (k, R, B) complex128 member
            amplitudes (signal phase folded in) and ``carriers`` (k, R)
            float64 member-independent frequencies, such that
            ``c_j(t, b) = Re[sum_r A[j,r,b] e^{i 2 pi carriers[j,r] t}]``.
            Alternatively ``(A, P)`` with ``P`` a complex128
            (T, n_nodes, k, R) PROFILE table —
            ``c_j(t_i, b) = Re[sum_r A[j,r,b] P[i, node, j, r]]`` — the
            rank-1/fixed-shape envelope case where one reference member's
            envelope trajectory (carrier folded in) is host-sampled and
            every member is a complex scale of it.
            ``coefficients`` must then be ``None`` and ``dt`` must be a
            (T,) array (the step count is otherwise unknown). The full
            (T, n_nodes, k, B) table is assembled ON DEVICE in df32
            arithmetic from host-f64 trig tables — host->device transfer
            drops from O(T * B) to O(T + B).
        devices: optional list of ``jax.Device`` — chunk dispatches
            round-robin across them (host-fed data parallelism; the
            invariant tables ship to every device once). ``None`` = the
            default device. Either way chunk result transfers are deferred
            until all chunks are enqueued, overlapping compute with the
            host link.
        eval_slots: optional tuple of per-step trajectory slots (length T
            ints; ``-1`` = no store, otherwise the state AFTER step ``j``
            writes slot ``eval_slots[j]``). When given the return value is
            ``(final, traj)`` with ``traj`` (n_eval, n, B) complex128 in
            the same (frame) basis as ``final``.

    Returns:
        (n, B) complex128 final states (frame basis) at ``t0 + sum(dt)``.
    """
    if magnus_order not in MAGNUS_NODES:
        raise ValueError(f"magnus_order must be one of {sorted(MAGNUS_NODES)}.")
    static_op = np.asarray(static_op, dtype=np.complex128)
    operators = np.asarray(operators, dtype=np.complex128)
    frame_omega = np.asarray(frame_omega, dtype=np.float64)
    y0 = np.asarray(y0, dtype=np.complex128)
    n = y0.shape[0]
    nodes = MAGNUS_NODES[magnus_order]
    if coef_factors is not None:
        if coefficients is not None:
            raise ValueError("pass either coefficients or coef_factors, not both.")
        fac_amps = np.asarray(coef_factors[0], dtype=np.complex128)
        k = operators.shape[0]
        if fac_amps.ndim != 3 or fac_amps.shape[0] != k:
            raise ValueError(
                f"coef_factors amplitudes must be (k={k}, R, B); got {fac_amps.shape}."
            )
        dts = np.asarray(dt, dtype=np.float64)
        if dts.ndim != 1:
            raise ValueError(
                "coef_factors requires dt as a (T,) per-step array (the step "
                "count is otherwise unknown)."
            )
        T, n_nodes, B = len(dts), len(nodes), fac_amps.shape[2]
        fac_second = np.asarray(coef_factors[1])
        if fac_second.ndim == 4:
            # precomputed complex PROFILE tables P (T, n_nodes, k, R):
            # c_j(t, b) = sum_r Re[A_jrb P_jr(t)] — the rank-1/fixed-shape
            # envelope case (host samples one reference member's envelope
            # trajectory; the member scales ship as A)
            fac_carriers = None
            fac_profile = np.asarray(fac_second, dtype=np.complex128)
            want = (T, n_nodes, k, fac_amps.shape[1])
            if fac_profile.shape != want:
                raise ValueError(
                    f"coef_factors profile must be shaped {want}; "
                    f"got {fac_profile.shape}."
                )
        else:
            fac_profile = None
            fac_carriers = np.asarray(fac_second, dtype=np.float64)
            if fac_carriers.shape != fac_amps.shape[:2]:
                raise ValueError(
                    f"coef_factors carriers must be shaped {fac_amps.shape[:2]}; "
                    f"got {fac_carriers.shape}."
                )
    else:
        fac_amps = None
        coefficients = np.asarray(coefficients, dtype=np.float64)
        T, n_nodes, k, B = coefficients.shape
        if n_nodes != len(nodes):
            raise ValueError(
                f"coefficients have {n_nodes} node samples; magnus_order="
                f"{magnus_order} needs {len(nodes)}."
            )
        dts = np.asarray(dt, dtype=np.float64)
        if dts.ndim == 0:
            dts = np.full(T, float(dts))
        if dts.shape != (T,):
            raise ValueError(f"dt must be a scalar or shape ({T},), got {dts.shape}.")

    # host f64 precompute: frame phase tables at the Gauss times
    t_start = t0 + np.concatenate([[0.0], np.cumsum(dts)[:-1]])
    tau = t_start[:, None] + dts[:, None] * nodes[None, :]
    # when omega is (to ~1e-13) an exact difference of a frequency vector —
    # always true for frames built from eigenvalues (omega_ij = w_j - w_i) —
    # ship only the (T, n_nodes, n) DIAGONAL phasors and form the (n, n)
    # tables on device as a df32 phasor product (the full tables are
    # O(T n^2) f64 — 60 MB for the 500-step dim-16 sweep — and their
    # host->device transfer was the second-largest cost of the whole call).
    # Using v = omega[0, :] instead of the original w shifts every phase by
    # <= |omega - (v_j - v_i)| * tau ~ 1e-10 rad over typical spans — far
    # below the df32 target.
    dev_list = list(devices) if devices else [None]

    def _dput(x, d):
        return jax.device_put(x, d) if d is not None else jax.device_put(x)

    v_freq = frame_omega[0, :]
    v_diff = v_freq[None, :] - v_freq[:, None]
    diag_ok = np.all(
        np.abs(frame_omega - v_diff) <= 1e-13 * np.maximum(1.0, np.abs(frame_omega))
    )
    if diag_ok:
        phv = v_freq[None, None, :] * tau[:, :, None]  # (T, n_nodes, n)
        phv_cos = df32.from_f64(np.cos(phv))
        phv_sin = df32.from_f64(np.sin(phv))
    else:
        ph = frame_omega[None, None] * tau[:, :, None, None]  # (T, n_nodes, n, n)
        ph_cos = df32.from_f64(np.cos(ph))
        ph_sin = df32.from_f64(np.sin(ph))

    # ship the per-call invariants to each device ONCE (they are reused by
    # every chunk dispatch). With multiple
    # ``devices`` the chunk dispatches round-robin — host-fed data
    # parallelism matching the engine's host-orchestrated design (the
    # shard_map path is f32-only).
    phases_by_dev, inv_by_dev = [], []
    for d in dev_list:
        if diag_ok:
            # computed ON device d (jit follows its committed inputs)
            ph_d = _frame_phases_from_diag(
                _dput(phv_cos, d), _dput(phv_sin, d)
            )
        else:
            ph_d = (_dput(ph_cos, d), _dput(ph_sin, d))
        phases_by_dev.append(ph_d)
        inv_by_dev.append(
            (
                _dput(df32.cfrom_f64(static_op), d),
                _dput(df32.cfrom_f64(operators), d),
                _dput(_rule_consts(magnus_order, order), d),
                _dput(_step_consts(magnus_order, dts), d),
            )
        )
    phases = phases_by_dev[0]
    stat, ops, consts, step_c = inv_by_dev[0]

    if fac_amps is not None:
        # factorized coefficients: carrier phase tables in host f64 (tiny —
        # (T, n_nodes, k, R)), member amplitudes split to df; the full
        # (T, n_nodes, k, Bc) table is assembled per chunk ON DEVICE
        if fac_profile is not None:
            # Re[A P] = Re(P) Re(A) - Im(P) Im(A): the combiner's cos/sin
            # table slots carry the profile's real/imag parts directly
            fc_host = df32.from_f64(fac_profile.real)
            fs_host = df32.from_f64(fac_profile.imag)
        else:
            theta = (
                2.0 * np.pi * fac_carriers[None, None] * tau[:, :, None, None]
            )  # (T, n_nodes, k, R)
            fc_host = df32.from_f64(np.cos(theta))
            fs_host = df32.from_f64(np.sin(theta))
        fac_tables_by_dev = [
            (_dput(fc_host, d), _dput(fs_host, d)) for d in dev_list
        ]
        fac_cos, fac_sin = fac_tables_by_dev[0]
        fac_re = df32.from_f64(fac_amps.real)
        fac_im = df32.from_f64(fac_amps.imag)
        n_terms = fac_amps.shape[1]
        coef_const = False
    else:
        # constant-envelope fast path: calibration sweeps evaluate the same
        # per-member value at every Gauss time, making the table rank-1 along
        # (T, n_nodes). Ship only (k, B) and broadcast on device —
        # (T, n_nodes, k, B) host->device transfers otherwise dominate.
        coef_const = bool(np.all(coefficients == coefficients[0:1, 0:1]))
        coef_compact = coefficients[0, 0] if coef_const else None

    out = np.empty((n, B), dtype=np.complex128)
    # chunk widths are quantized (multiples of 256, capped at chunk_b) so
    # different sweep sizes reuse the same compiled shapes — the chebyshev
    # node batches (17, 16, 32, ... members) otherwise pay one compile PER
    # refinement level
    quantum = min(256, chunk_b)
    pending = []
    for c_idx, lo_b in enumerate(range(0, B, chunk_b)):
        d_idx = c_idx % len(dev_list)
        d = dev_list[d_idx]
        phases = phases_by_dev[d_idx]
        stat, ops, consts, step_c = inv_by_dev[d_idx]
        hi_b = min(lo_b + chunk_b, B)
        width = hi_b - lo_b
        padded_width = min(chunk_b, -(-width // quantum) * quantum)
        pad = padded_width - width
        y_sl = y0[:, lo_b:hi_b]
        if pad:
            y_sl = np.concatenate([y_sl, np.repeat(y_sl[:, :1], pad, axis=-1)], axis=-1)
        if fac_amps is not None:
            fac_cos, fac_sin = fac_tables_by_dev[d_idx]
            a_re = tuple(x[..., lo_b:hi_b] for x in fac_re)
            a_im = tuple(x[..., lo_b:hi_b] for x in fac_im)
            if pad:
                a_re = tuple(
                    np.concatenate([x, np.repeat(x[..., :1], pad, axis=-1)], axis=-1)
                    for x in a_re
                )
                a_im = tuple(
                    np.concatenate([x, np.repeat(x[..., :1], pad, axis=-1)], axis=-1)
                    for x in a_im
                )
            if d is not None:
                a_re = _dput(a_re, d)
                a_im = _dput(a_im, d)
            coefs_dev = _combine_factor_table(
                fac_cos, fac_sin, a_re, a_im, n_terms=n_terms
            )
        else:
            sl = (coef_compact if coef_const else coefficients)[..., lo_b:hi_b]
            if pad:
                sl = np.concatenate([sl, np.repeat(sl[..., :1], pad, axis=-1)], axis=-1)
            coefs_dev = df32.from_f64(sl)
        res = _df_scan(
            n, k, order, magnus_order, stat, ops, phases,
            coefs_dev, df32.cfrom_f64(y_sl), consts, step_c,
            hermitian=hermitian, fast_commutators=fast_commutators,
            horner_df_tail=horner_df_tail, coef_const=coef_const,
            eval_slots=eval_slots,
        )
        # transfers are deferred: every chunk dispatch is enqueued (round-
        # robin across ``devices``) before the first result is pulled back,
        # so device compute overlaps host transfer and devices run
        # concurrently
        pending.append((lo_b, hi_b, res))
    out_traj = (
        None
        if eval_slots is None
        else np.empty((max(eval_slots) + 1, n, B), dtype=np.complex128)
    )
    for lo_b, hi_b, res in pending:
        if eval_slots is not None:
            res, traj = res
            tr = df32.cto_f64(_unflatten_c(traj))
            out_traj[:, :, lo_b:hi_b] = tr[..., : hi_b - lo_b]
        chunk = df32.cto_f64(_unflatten_c(res))
        out[:, lo_b:hi_b] = chunk[:, : hi_b - lo_b]
    return out if eval_slots is None else (out, out_traj)
