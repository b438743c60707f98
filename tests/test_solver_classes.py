"""Solver class tests: type handling, signal/RWA handling, pulse simulation."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.linalg import expm

from qiskit_dynamics_tpu.solvers import Solver
from qiskit_dynamics_tpu.signals import Signal
from qiskit_dynamics_tpu.quantum_info import Statevector, DensityMatrix, Operator, SuperOp
from qiskit_dynamics_tpu.pulse import Schedule, Play, Gaussian, Constant, ShiftPhase
from qiskit_dynamics_tpu.exceptions import DynamicsError

X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)

NU = 5.0
H0 = 2 * np.pi * NU * Z / 2
HD = 2 * np.pi * X / 2
R = 0.1


def make_solver(**kwargs):
    return Solver(
        static_hamiltonian=H0,
        hamiltonian_operators=[R * HD],
        rotating_frame=H0,
        **kwargs,
    )


def rabi_signals():
    return [Signal(1.0, carrier_freq=NU)]


def test_statevector_roundtrip():
    solver = make_solver()
    y0 = Statevector([1.0, 0.0])
    T = 1 / R  # inversion time: cos drive gives effective Rabi rate R/2
    res = solver.solve(t_span=[0, T], y0=y0, signals=rabi_signals(), atol=1e-10, rtol=1e-10)
    yf = res.y[-1]
    assert isinstance(yf, Statevector)
    # near-complete population transfer
    assert np.abs(np.asarray(yf.data)[1]) ** 2 > 0.99


def test_density_matrix_hamiltonian_conjugation():
    solver = make_solver()
    y0_sv = Statevector([1.0, 0.0])
    y0_dm = DensityMatrix(np.outer([1, 0], [1, 0]).astype(complex))
    T = 1 / R / 4
    res_sv = solver.solve([0, T], y0_sv, rabi_signals(), atol=1e-10, rtol=1e-10)
    res_dm = solver.solve([0, T], y0_dm, rabi_signals(), atol=1e-10, rtol=1e-10)
    yf_dm = res_dm.y[-1]
    assert isinstance(yf_dm, DensityMatrix)
    sv = np.asarray(res_sv.y[-1].data)
    np.testing.assert_allclose(np.asarray(yf_dm.data), np.outer(sv, sv.conj()), atol=1e-8)


def test_operator_input_gives_unitary():
    solver = make_solver()
    T = 0.5
    res = solver.solve([0, T], Operator(np.eye(2, dtype=complex)), rabi_signals(),
                       atol=1e-12, rtol=1e-12)
    U = np.asarray(res.y[-1].data)
    # unitarity
    np.testing.assert_allclose(U @ U.conj().T, np.eye(2), atol=1e-8)


def test_superop_hamiltonian():
    solver = make_solver()
    T = 0.3
    res_u = solver.solve([0, T], Operator(np.eye(2, dtype=complex)), rabi_signals(),
                         atol=1e-12, rtol=1e-12)
    U = np.asarray(res_u.y[-1].data)
    res_s = solver.solve([0, T], SuperOp(np.eye(4, dtype=complex)), rabi_signals(),
                         atol=1e-12, rtol=1e-12)
    S = np.asarray(res_s.y[-1].data)
    np.testing.assert_allclose(S, np.kron(U.conj(), U), atol=1e-8)


def test_lindblad_density_matrix():
    solver = Solver(
        static_hamiltonian=H0,
        hamiltonian_operators=[R * HD],
        dissipator_operators=[0.05 * X],
        rotating_frame=H0,
    )
    y0 = DensityMatrix(np.diag([1.0, 0.0]).astype(complex))
    res = solver.solve([0, 1.0], y0, (rabi_signals(), [Signal(1.0)]), atol=1e-10, rtol=1e-10)
    yf = res.y[-1]
    assert isinstance(yf, DensityMatrix)
    np.testing.assert_allclose(np.trace(np.asarray(yf.data)), 1.0, atol=1e-8)


def test_vectorized_lindblad_superop_and_dm():
    solver = Solver(
        static_hamiltonian=H0,
        dissipator_operators=[0.05 * X],
        vectorized=True,
    )
    y0 = DensityMatrix(np.diag([1.0, 0.0]).astype(complex))
    res = solver.solve([0, 1.0], y0, (None, [Signal(1.0)]), atol=1e-10, rtol=1e-10)
    yf = res.y[-1]
    assert isinstance(yf, DensityMatrix)
    np.testing.assert_allclose(np.trace(np.asarray(yf.data)), 1.0, atol=1e-8)

    res_s = solver.solve([0, 1.0], SuperOp(np.eye(4, dtype=complex)), (None, [Signal(1.0)]),
                         atol=1e-10, rtol=1e-10)
    assert isinstance(res_s.y[-1], SuperOp)
    # applying the superop to vec(rho0) matches direct dm evolution
    S = np.asarray(res_s.y[-1].data)
    rho_f = (S @ np.asarray(y0.data).flatten(order="F")).reshape(2, 2, order="F")
    np.testing.assert_allclose(rho_f, np.asarray(yf.data), atol=1e-6)


def test_superop_unvectorized_lindblad_raises():
    solver = Solver(static_hamiltonian=H0, dissipator_operators=[0.05 * X])
    with pytest.raises(DynamicsError):
        solver.solve([0, 1.0], SuperOp(np.eye(4, dtype=complex)), (None, [Signal(1.0)]))


def test_multiple_sims_broadcasting():
    solver = make_solver()
    y0 = Statevector([1.0, 0.0])
    sigs = [[Signal(a, carrier_freq=NU)] for a in [0.5, 1.0, 1.5]]
    results = solver.solve([0, 1.0], y0, sigs, atol=1e-8, rtol=1e-8)
    assert isinstance(results, list) and len(results) == 3


def test_rwa_solver_matches_full():
    """RWA solve approximates the full solve for weak drive."""
    full = make_solver()
    rwa = make_solver(rwa_cutoff_freq=1.5 * NU, rwa_carrier_freqs=[NU])
    y0 = Statevector([1.0, 0.0])
    T = 1 / R / 4
    res_full = full.solve([0, T], y0, rabi_signals(), atol=1e-10, rtol=1e-10)
    res_rwa = rwa.solve([0, T], y0, rabi_signals(), atol=1e-10, rtol=1e-10)
    p_full = np.abs(np.asarray(res_full.y[-1].data)) ** 2
    p_rwa = np.abs(np.asarray(res_rwa.y[-1].data)) ** 2
    np.testing.assert_allclose(p_full, p_rwa, atol=5e-2)


def pulse_solver(**kwargs):
    return Solver(
        static_hamiltonian=H0,
        hamiltonian_operators=[HD],
        hamiltonian_channels=["d0"],
        channel_carrier_freqs={"d0": NU},
        dt=0.1,
        rotating_frame=H0,
        **kwargs,
    )


def test_pulse_schedule_simulation():
    solver = pulse_solver()
    sched = Schedule(Play(Constant(duration=100, amp=R), "d0"))
    y0 = Statevector([1.0, 0.0])
    res = solver.solve([0, 100 * 0.1], y0, sched, atol=1e-10, rtol=1e-10)
    yf = res.y[-1]
    assert isinstance(yf, Statevector)
    # constant amp R drive for T = 10 = 1/R: population inversion (RWA rate R/2)
    assert np.abs(np.asarray(yf.data)[1]) ** 2 > 0.95


def test_pulse_schedule_jit_path_matches_signal_path():
    solver = pulse_solver()
    sched = Schedule(Play(Gaussian(duration=100, amp=0.3, sigma=20), "d0"))
    y0 = Statevector([1.0, 0.0])
    res_jax = solver.solve([0, 10.0], y0, [sched, sched], method="tpu_dopri5",
                           atol=1e-10, rtol=1e-10)
    res_host = solver.solve([0, 10.0], y0, sched, method="DOP853", atol=1e-10, rtol=1e-10)
    assert len(res_jax) == 2
    np.testing.assert_allclose(
        np.asarray(res_jax[0].y[-1].data), np.asarray(res_jax[1].y[-1].data), atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(res_jax[0].y[-1].data), np.asarray(res_host.y[-1].data), atol=1e-6
    )


def test_pulse_phase_shift():
    """ShiftPhase rotates the drive axis; probability unaffected for single pulse."""
    solver = pulse_solver()
    sched1 = Schedule(Play(Constant(duration=50, amp=R), "d0"))
    sched2 = Schedule(
        ShiftPhase(np.pi / 2, "d0"), Play(Constant(duration=50, amp=R), "d0")
    )
    y0 = Statevector([1.0, 0.0])
    r1 = solver.solve([0, 5.0], y0, sched1, atol=1e-10, rtol=1e-10)
    r2 = solver.solve([0, 5.0], y0, sched2, atol=1e-10, rtol=1e-10)
    p1 = np.abs(np.asarray(r1.y[-1].data)[1]) ** 2
    p2 = np.abs(np.asarray(r2.y[-1].data)[1]) ** 2
    # equal up to small beyond-RWA (counter-rotating) corrections
    np.testing.assert_allclose(p1, p2, atol=1e-3)
    # but the states differ (phase present)
    assert not np.allclose(np.asarray(r1.y[-1].data), np.asarray(r2.y[-1].data), atol=1e-3)


def test_schedule_batch_vmapped_matches_serial():
    """Batched schedule fast path (one vmapped call) == per-schedule solves."""
    import numpy as np
    import jax.numpy as jnp
    from qiskit_dynamics_tpu import Solver
    from qiskit_dynamics_tpu.pulse import Schedule, Play, DriveChannel, Constant

    nu, r = 5.0, 0.1
    X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
    Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
    solver = Solver(
        static_hamiltonian=2 * np.pi * nu * Z / 2,
        hamiltonian_operators=[2 * np.pi * r * X / 2],
        hamiltonian_channels=["d0"],
        channel_carrier_freqs={"d0": nu},
        dt=0.1,
        rotating_frame=2 * np.pi * nu * Z / 2,
    )
    y0 = np.array([1.0, 0.0], dtype=complex)
    scheds = []
    for amp in [0.3, 0.6, 0.9]:
        s = Schedule(name=f"amp{amp}")
        s.append(Play(Constant(duration=40, amp=amp), DriveChannel(0)))
        scheds.append(s)

    # batch path: same t_span/y0 for all -> vmapped single call
    batch_results = solver.solve(
        t_span=[0.0, 4.0], y0=y0, signals=scheds, method="tpu_dopri5",
        atol=1e-10, rtol=1e-10, convert_results=False,
    )
    assert isinstance(batch_results, list) and len(batch_results) == 3

    # serial reference: one schedule at a time
    for sched, batch_res in zip(scheds, batch_results):
        single = solver.solve(
            t_span=[0.0, 4.0], y0=y0, signals=sched, method="tpu_dopri5",
            atol=1e-10, rtol=1e-10, convert_results=False,
        )
        np.testing.assert_allclose(
            np.asarray(batch_res.y[-1]), np.asarray(single.y[-1]), atol=1e-8
        )


class TestFusedScheduleSolve:
    """`method='fused_dopri5'`: schedule batches through the fused adaptive
    engine (no reference counterpart)."""

    @staticmethod
    def _pulse_solver(**kwargs):
        from qiskit_dynamics_tpu.pulse import DriveChannel  # noqa: F401

        return Solver(
            static_hamiltonian=H0,
            hamiltonian_operators=[2 * np.pi * R * X / 2],
            hamiltonian_channels=["d0"],
            channel_carrier_freqs={"d0": NU},
            dt=0.1,
            rotating_frame=H0,
            **kwargs,
        )

    @staticmethod
    def _schedules(amps, duration=40, sigma=8):
        from qiskit_dynamics_tpu.pulse import DriveChannel

        scheds = []
        for amp in amps:
            s = Schedule(name=f"amp{amp}")
            s.append(Play(Gaussian(duration=duration, amp=amp, sigma=sigma), DriveChannel(0)))
            scheds.append(s)
        return scheds

    def test_matches_adaptive_reference(self):
        solver = self._pulse_solver()
        y0 = np.array([1.0, 0.0], dtype=complex)
        scheds = self._schedules([0.3, 0.6, 0.9])
        ref = solver.solve(
            t_span=[0.0, 4.0], y0=y0, signals=scheds, method="tpu_dopri5",
            atol=1e-12, rtol=1e-12, convert_results=False,
        )
        fused = solver.solve(
            t_span=[0.0, 4.0], y0=y0, signals=scheds, method="fused_dopri5",
            interpret=True, convert_results=False,
        )
        assert len(fused) == 3
        for a, b in zip(ref, fused):
            # serving default tolerance is 5e-8 (the engine's own default of
            # 1e-6 is far less accurate on the dim-27 serving config)
            np.testing.assert_allclose(
                np.asarray(a.y[-1]), np.asarray(b.y[-1]), atol=1e-5
            )

    def test_serving_default_tolerance_pinned(self):
        """The fused serving path defaults to atol=rtol=5e-8: solving with
        defaults must match an EXPLICIT 5e-8 solve exactly and be much more
        accurate than the engine's bare 1e-6 default."""
        solver = self._pulse_solver()
        y0 = np.array([1.0, 0.0], dtype=complex)
        scheds = self._schedules([0.7])
        kw = dict(
            t_span=[0.0, 4.0], y0=y0, signals=scheds, method="fused_dopri5",
            interpret=True, convert_results=False,
        )
        default = solver.solve(**kw)
        explicit = solver.solve(atol=5e-8, rtol=5e-8, **kw)
        np.testing.assert_array_equal(
            np.asarray(default[0].y[-1]), np.asarray(explicit[0].y[-1])
        )
        loose = solver.solve(atol=1e-6, rtol=1e-6, **kw)
        ref = solver.solve(
            t_span=[0.0, 4.0], y0=y0, signals=scheds, method="tpu_dopri5",
            atol=1e-12, rtol=1e-12, convert_results=False,
        )
        err_default = np.max(np.abs(np.asarray(default[0].y[-1]) - np.asarray(ref[0].y[-1])))
        err_loose = np.max(np.abs(np.asarray(loose[0].y[-1]) - np.asarray(ref[0].y[-1])))
        assert err_default < 1e-5
        assert err_default < err_loose / 5, (err_default, err_loose)

    def test_grouped_t_spans(self):
        """Mixed t_spans are grouped; each group one engine call."""
        solver = self._pulse_solver()
        y0 = np.array([1.0, 0.0], dtype=complex)
        scheds = self._schedules([0.4, 0.8, 0.4, 0.8], duration=40)
        t_spans = [[0.0, 4.0], [0.0, 2.0], [0.0, 2.0], [0.0, 4.0]]
        fused = solver.solve(
            t_span=t_spans, y0=y0, signals=scheds, method="fused_dopri5",
            interpret=True, convert_results=False,
        )
        for ts, sched, res in zip(t_spans, scheds, fused):
            ref = solver.solve(
                t_span=ts, y0=y0, signals=sched, method="tpu_dopri5",
                atol=1e-12, rtol=1e-12, convert_results=False,
            )
            assert res.t[-1] == ts[-1]
            np.testing.assert_allclose(
                np.asarray(ref.y[-1]), np.asarray(res.y[-1]), atol=1e-4
            )

    def test_statevector_wrapping(self):
        solver = self._pulse_solver()
        y0 = Statevector([1.0, 0.0])
        res = solver.solve(
            t_span=[0.0, 4.0], y0=y0, signals=self._schedules([0.5, 0.7]),
            method="fused_dopri5", interpret=True,
        )
        assert all(isinstance(r.y[-1], Statevector) for r in res)
        assert np.allclose(np.asarray(res[0].y[0].data), [1.0, 0.0])

    def test_density_matrix_y0(self):
        """DM + HamiltonianModel: simulate unitary columns, conjugate."""
        solver = self._pulse_solver()
        sched = self._schedules([0.8])[0]
        dm0 = DensityMatrix(np.diag([0.75, 0.25]).astype(complex))
        ref = solver.solve(
            t_span=[0.0, 4.0], y0=dm0, signals=sched, method="tpu_dopri5",
            atol=1e-12, rtol=1e-12,
        )
        fused = solver.solve(
            t_span=[0.0, 4.0], y0=dm0, signals=[sched], method="fused_dopri5",
            interpret=True,
        )[0]
        assert isinstance(fused.y[-1], DensityMatrix)
        np.testing.assert_allclose(
            np.asarray(ref.y[-1].data), np.asarray(fused.y[-1].data), atol=1e-4
        )
        np.testing.assert_allclose(np.asarray(fused.y[0].data), np.asarray(dm0.data))

    def test_vectorized_lindblad(self):
        from qiskit_dynamics_tpu.pulse import DriveChannel

        solver = Solver(
            static_hamiltonian=H0,
            hamiltonian_operators=[2 * np.pi * R * X / 2],
            static_dissipators=[0.05 * np.array([[0.0, 1.0], [0.0, 0.0]])],
            hamiltonian_channels=["d0"],
            channel_carrier_freqs={"d0": NU},
            dt=0.1,
            rotating_frame=H0,
            vectorized=True,
        )
        sched = self._schedules([0.8])[0]
        dm0 = DensityMatrix(np.diag([1.0, 0.0]).astype(complex))
        ref = solver.solve(
            t_span=[0.0, 4.0], y0=dm0, signals=sched, method="tpu_dopri5",
            atol=1e-12, rtol=1e-12,
        )
        fused = solver.solve(
            t_span=[0.0, 4.0], y0=dm0, signals=[sched], method="fused_dopri5",
            interpret=True,
        )[0]
        assert isinstance(fused.y[-1], DensityMatrix)
        np.testing.assert_allclose(
            np.asarray(ref.y[-1].data), np.asarray(fused.y[-1].data), atol=1e-4
        )

    def test_shared_y0_required(self):
        solver = self._pulse_solver()
        scheds = self._schedules([0.3, 0.6])
        with pytest.raises(DynamicsError, match="shared y0"):
            solver.solve(
                t_span=[0.0, 4.0],
                y0=[np.array([1.0, 0.0], dtype=complex), np.array([0.0, 1.0], dtype=complex)],
                signals=scheds, method="fused_dopri5", interpret=True,
            )

    def test_bad_kwargs_raise(self):
        solver = self._pulse_solver()
        with pytest.raises(DynamicsError, match="unsupported kwargs"):
            solver.solve(
                t_span=[0.0, 4.0], y0=np.array([1.0, 0.0], dtype=complex),
                signals=self._schedules([0.5]), method="fused_dopri5",
                not_an_option=0.1,
            )
        # max_dt is a df32-only option (round 5): supported but gated
        with pytest.raises(DynamicsError, match="df32"):
            solver.solve(
                t_span=[0.0, 4.0], y0=np.array([1.0, 0.0], dtype=complex),
                signals=self._schedules([0.5]), method="fused_dopri5", max_dt=0.1,
            )

    def test_requires_schedules(self):
        solver = make_solver()
        with pytest.raises(DynamicsError, match="Schedule"):
            solver.solve(
                t_span=[0, 1], y0=np.array([1.0, 0.0], dtype=complex),
                signals=rabi_signals(), method="fused_dopri5",
            )


class TestSolverValidation:
    """Constructor/solve validation errors (reference analog:
    test_solver_classes.py validation battery)."""

    def test_no_operators_raises(self):
        with pytest.raises(DynamicsError):
            Solver()

    def test_signal_count_mismatch(self):
        solver = make_solver()
        with pytest.raises(Exception):
            solver.solve(
                t_span=[0, 1], y0=np.array([1.0, 0.0], dtype=complex),
                signals=[Signal(1.0, carrier_freq=NU), Signal(1.0, carrier_freq=NU)],
            )

    def test_y0_shape_mismatch(self):
        solver = make_solver()
        with pytest.raises(DynamicsError, match="[Ss]hape"):
            solver.solve(
                t_span=[0, 1], y0=np.zeros(3, dtype=complex), signals=rabi_signals()
            )

    def test_pulse_mode_requires_dt(self):
        with pytest.raises(Exception):
            Solver(
                static_hamiltonian=H0,
                hamiltonian_operators=[R * HD],
                hamiltonian_channels=["d0"],
                channel_carrier_freqs={"d0": NU},
            )

    def test_schedule_without_pulse_config_raises(self):
        solver = make_solver()
        sched = Schedule()
        sched.append(Play(Constant(duration=8, amp=0.1), __import__(
            "qiskit_dynamics_tpu.pulse.schedule", fromlist=["DriveChannel"]
        ).DriveChannel(0)))
        with pytest.raises(Exception):
            solver.solve(t_span=[0, 1], y0=np.array([1.0, 0.0], dtype=complex),
                         signals=sched)

    def test_missing_channel_freq_raises(self):
        with pytest.raises(Exception):
            Solver(
                static_hamiltonian=H0,
                hamiltonian_operators=[R * HD],
                hamiltonian_channels=["d0"],
                channel_carrier_freqs={"d1": NU},
                dt=0.1,
            )


class TestSolverJaxTransforms:
    """jit/grad through Solver.solve (reference: test_solver_classes.py:701-781)."""

    def test_jit_solve_signal_amp(self):
        solver = make_solver()
        y0 = np.array([1.0, 0.0], dtype=complex)

        @jax.jit
        def pop1(amp):
            res = solver.solve(
                t_span=[0, 1 / R], y0=y0,
                signals=[Signal(amp, carrier_freq=NU)],
                method="tpu_dopri5", atol=1e-10, rtol=1e-10,
            )
            return jnp.abs(res.y[-1][1]) ** 2

        np.testing.assert_allclose(float(pop1(1.0)), 1.0, atol=1e-4)

    def test_grad_solve_signal_amp(self):
        solver = make_solver()
        y0 = np.array([1.0, 0.0], dtype=complex)

        def pop1(amp):
            res = solver.solve(
                t_span=[0, 1 / (2 * R)], y0=y0,
                signals=[Signal(amp, carrier_freq=NU)],
                method="tpu_dopri5", atol=1e-10, rtol=1e-10,
            )
            return jnp.abs(res.y[-1][1]) ** 2

        # p1(amp) = sin^2(pi amp / 4) at T = 1/(2R): dp/damp = pi/4 sin(pi amp/2)
        g = jax.grad(pop1)(1.0)
        np.testing.assert_allclose(float(g), np.pi / 4, atol=1e-3)

    def test_jit_grad_through_traced_schedule(self):
        """Schedules built from traced pulse parameters run through
        Solver.solve under jit/grad (the converter + padding stay in the
        trace; beyond-reference — the reference's schedule path is
        host-only)."""
        solver = pulse_solver()
        y0 = np.array([1.0, 0.0], dtype=complex)

        def pop1(amp):
            sched = Schedule(Play(Constant(duration=100, amp=amp), "d0"))
            res = solver.solve(
                [0, 100 * 0.1], y0, sched, method="jax_odeint",
                atol=1e-10, rtol=1e-10,
            )
            return jnp.abs(res.y[-1][1]) ** 2

        # constant amp R for T = 1/R: full inversion
        np.testing.assert_allclose(float(jax.jit(pop1)(R)), 1.0, atol=1e-4)
        # p1(amp) = sin^2(pi amp / (2R)) at T = 1/R: zero slope at inversion
        np.testing.assert_allclose(float(jax.grad(pop1)(R)), 0.0, atol=1e-3)
        # and maximal slope pi/(2R) at half inversion
        g = jax.grad(pop1)(R / 2)
        np.testing.assert_allclose(float(g), np.pi / (2 * R), rtol=1e-3)

    def test_vmap_solve(self):
        solver = make_solver()
        y0 = np.array([1.0, 0.0], dtype=complex)

        def pop1(amp):
            res = solver.solve(
                t_span=[0, 1 / R], y0=y0,
                signals=[Signal(amp, carrier_freq=NU)],
                method="tpu_dopri5", atol=1e-10, rtol=1e-10,
            )
            return jnp.abs(res.y[-1][1]) ** 2

        amps = jnp.array([0.25, 0.5, 1.0])
        pops = jax.vmap(pop1)(amps)
        expected = np.sin(np.pi * np.asarray(amps) / 2) ** 2
        np.testing.assert_allclose(np.asarray(pops), expected, atol=1e-4)


class TestSolverTEval:
    def test_t_eval_through_solver(self):
        solver = make_solver()
        y0 = np.array([1.0, 0.0], dtype=complex)
        t_eval = [0.0, 2.5, 5.0]
        res = solver.solve(
            t_span=[0, 5.0], y0=y0, signals=rabi_signals(),
            t_eval=t_eval, method="DOP853", atol=1e-12, rtol=1e-12,
        )
        assert len(res.y) == 3
        # p1(t) = sin^2(pi R t / 2)
        for t, y in zip(t_eval, res.y):
            np.testing.assert_allclose(
                np.abs(np.asarray(y)[1]) ** 2,
                np.sin(np.pi * R * t / 2) ** 2, atol=5e-3,
            )

    def test_t_eval_jax_method(self):
        solver = make_solver()
        y0 = np.array([1.0, 0.0], dtype=complex)
        t_eval = [1.0, 3.0]
        res = solver.solve(
            t_span=[0, 5.0], y0=y0, signals=rabi_signals(),
            t_eval=t_eval, method="tpu_dopri5", atol=1e-10, rtol=1e-10,
        )
        assert len(res.y) == 2
        for t, y in zip(t_eval, res.y):
            np.testing.assert_allclose(
                np.abs(np.asarray(y)[1]) ** 2,
                np.sin(np.pi * R * t / 2) ** 2, atol=5e-3,
            )


def test_pulse_dissipator_channels():
    """Pulse-configured Lindblad: schedule-driven dissipator rates match a
    manually-constructed DiscreteSignal solve (ref solver_classes pulse
    channel config incl. dissipator_channels)."""
    from qiskit_dynamics_tpu.pulse import DriveChannel
    from qiskit_dynamics_tpu.signals import DiscreteSignal

    L = np.array([[0.0, 1.0], [0.0, 0.0]], dtype=complex)
    solver = Solver(
        static_hamiltonian=H0,
        hamiltonian_operators=[HD],
        dissipator_operators=[L],
        hamiltonian_channels=["d0"],
        dissipator_channels=["d1"],
        channel_carrier_freqs={"d0": NU, "d1": 0.0},
        dt=0.1,
        rotating_frame=H0,
    )
    rho0 = DensityMatrix(np.diag([0.0, 1.0]).astype(complex))
    sched = Schedule(name="damp")
    sched.append(Play(Constant(duration=20, amp=0.1), DriveChannel(0)))
    sched.append(Play(Constant(duration=20, amp=0.5), DriveChannel(1)))

    res_sched = solver.solve(
        t_span=[0.0, 2.0], y0=rho0, signals=sched, atol=1e-10, rtol=1e-10
    )

    manual = Solver(
        static_hamiltonian=H0,
        hamiltonian_operators=[HD],
        dissipator_operators=[L],
        rotating_frame=H0,
    )
    ham_sig = DiscreteSignal(dt=0.1, samples=[0.1] * 20, carrier_freq=NU)
    dis_sig = DiscreteSignal(dt=0.1, samples=[0.5] * 20, carrier_freq=0.0)
    res_manual = manual.solve(
        t_span=[0.0, 2.0], y0=rho0, signals=([ham_sig], [dis_sig]),
        atol=1e-10, rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(res_sched.y[-1].data), np.asarray(res_manual.y[-1].data), atol=1e-8
    )
    # the dissipator actually acted: excited population decayed
    assert np.real(np.asarray(res_sched.y[-1].data)[1, 1]) < 0.95


class TestSolveSweep:
    """Public fused-sweep entry point on Solver (auto-wired RWA map)."""

    def _setup(self):
        import jax.numpy as jnp
        from qiskit_dynamics_tpu.benchmarks import cr_solver
        from qiskit_dynamics_tpu import Signal

        solver, w1 = cr_solver(dim=2)
        y0 = np.zeros(4, dtype=complex)
        y0[0] = 1.0

        def signals_fn(amp):
            return [Signal(lambda t: amp * 0.02, carrier_freq=w1)]

        return solver, w1, y0, signals_fn, jnp.array([0.3, 0.75, 1.0, 0.5])

    def test_fused_magnus2_matches_direct_call(self):
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        solver, _, y0, signals_fn, amps = self._setup()
        via_solver = solver.solve_sweep(
            signals_fn, amps, t_span=(0.0, 2.0), y0=y0,
            method="fused_magnus2", max_dt=0.5,
        )
        direct = fused_sweep_solve(
            solver.model, signals_fn, amps, t_span=(0.0, 2.0), max_dt=0.5,
            y0=y0, rwa_signal_map=solver._rwa_signal_map,
        )
        np.testing.assert_allclose(np.asarray(via_solver), np.asarray(direct), atol=1e-14)

    def test_fused_dopri5_and_validation(self):
        import pytest
        from qiskit_dynamics_tpu.exceptions import DynamicsError

        solver, _, y0, signals_fn, amps = self._setup()
        out = solver.solve_sweep(
            signals_fn, amps, t_span=(0.0, 2.0), y0=y0,
            method="fused_dopri5", tile_b=16, interpret=True,
        )
        assert out.shape == (4, 4)
        with pytest.raises(DynamicsError, match="solve_sweep method"):
            solver.solve_sweep(
                signals_fn, amps, t_span=(0.0, 2.0), y0=y0, method="nope"
            )

    def test_explicit_rwa_signal_map_overrides_auto_wiring(self):
        from qiskit_dynamics_tpu.solvers import fused_sweep_solve

        solver, _, y0, signals_fn, amps = self._setup()
        # identity map instead of the solver's RWA map: must not raise a
        # duplicate-kwarg TypeError, and must change the result
        rwa_sigs_fn = lambda amp: list(solver._rwa_signal_map(signals_fn(amp)))
        via_override = solver.solve_sweep(
            rwa_sigs_fn, amps, t_span=(0.0, 2.0), y0=y0,
            method="fused_magnus2", max_dt=0.5,
            rwa_signal_map=None,
        )
        auto = solver.solve_sweep(
            signals_fn, amps, t_span=(0.0, 2.0), y0=y0,
            method="fused_magnus2", max_dt=0.5,
        )
        np.testing.assert_allclose(
            np.asarray(via_override), np.asarray(auto), atol=1e-13
        )


class TestSolverHermiticityValidation:
    """Hermiticity validation + override and signals=None semantics
    (reference test_solver_classes.py validation families)."""

    def test_non_hermitian_hamiltonian_operator_raises(self):
        bad = np.array([[0.0, 1.0], [0.0, 0.0]], dtype=complex)
        with pytest.raises(DynamicsError, match="Hermitian"):
            Solver(static_hamiltonian=Z, hamiltonian_operators=[bad])

    def test_validate_false_overrides_hermiticity_check(self):
        bad = np.array([[0.0, 1.0], [0.0, 0.0]], dtype=complex)
        solver = Solver(
            static_hamiltonian=Z, hamiltonian_operators=[bad], validate=False
        )
        res = solver.solve(
            t_span=[0.0, 0.1], y0=np.array([1.0, 0.0], dtype=complex),
            signals=[Signal(1.0)], method="RK4", max_dt=0.05,
        )
        assert np.asarray(res.y[-1]).shape == (2,)

    def test_non_hermitian_lindblad_hamiltonian_raises(self):
        bad = np.array([[0.0, 1.0], [0.0, 0.0]], dtype=complex)
        with pytest.raises(DynamicsError, match="Hermitian"):
            Solver(
                static_hamiltonian=Z, hamiltonian_operators=[bad],
                static_dissipators=[0.1 * X],
            )

    def test_validate_false_lindblad(self):
        bad = np.array([[0.0, 1.0], [0.0, 0.0]], dtype=complex)
        solver = Solver(
            static_hamiltonian=Z, hamiltonian_operators=[bad],
            static_dissipators=[0.1 * X], validate=False,
        )
        rho0 = np.array([[1.0, 0.0], [0.0, 0.0]], dtype=complex)
        res = solver.solve(
            t_span=[0.0, 0.1], y0=rho0, signals=([Signal(1.0)], None),
            method="RK4", max_dt=0.05,
        )
        assert np.asarray(res.y[-1]).shape == (2, 2)

    def test_static_only_solve_no_signals(self):
        # no operators: solving with signals=None gives pure static evolution
        solver = Solver(static_hamiltonian=Z)
        y0 = np.array([1.0, 1.0], dtype=complex) / np.sqrt(2)
        res = solver.solve(
            t_span=[0.0, 1.0], y0=y0, method="DOP853", atol=1e-12, rtol=1e-12
        )
        expect = expm(-1j * np.asarray(Z, dtype=complex)) @ y0
        np.testing.assert_allclose(np.asarray(res.y[-1]), expect, atol=1e-9)

    def test_statevector_dims_preserved(self):
        from qiskit_dynamics_tpu.quantum_info import Statevector

        solver = Solver(
            static_hamiltonian=np.kron(Z, Z),
            hamiltonian_operators=[np.kron(X, np.eye(2))],
        )
        y0 = Statevector(
            np.array([1.0, 0, 0, 0], dtype=complex), dims=(2, 2)
        )
        res = solver.solve(
            t_span=[0.0, 0.2], y0=y0, signals=[Signal(1.0)],
            method="RK4", max_dt=0.05,
        )
        out = res.y[-1]
        assert isinstance(out, Statevector)
        assert tuple(out.dims()) == (2, 2)

    def test_mixed_y0_list_simulation(self):
        # list of simulations with different y0 types in one call
        from qiskit_dynamics_tpu.quantum_info import Statevector, DensityMatrix

        solver = Solver(static_hamiltonian=Z, hamiltonian_operators=[X])
        y0s = [
            Statevector(np.array([1.0, 0.0], dtype=complex)),
            DensityMatrix(np.array([[1.0, 0], [0, 0]], dtype=complex)),
        ]
        results = [
            solver.solve(
                t_span=[0.0, 0.1], y0=y0, signals=[Signal(1.0)],
                method="RK4", max_dt=0.05,
            )
            for y0 in y0s
        ]
        assert isinstance(results[0].y[-1], Statevector)
        assert isinstance(results[1].y[-1], DensityMatrix)
        # consistency: |psi><psi| evolution matches density-matrix evolution
        psi = np.asarray(results[0].y[-1].data)
        rho = np.asarray(results[1].y[-1].data)
        np.testing.assert_allclose(np.outer(psi, psi.conj()), rho, atol=1e-8)


class TestSolverSignalHandling:
    """Model-signal purity and RWA signal translation (reference
    TestSolverSignalHandling, test_solver_classes.py:260-460)."""

    def _ham_solver(self, rwa=False):
        kw = {}
        if rwa:
            kw = dict(rwa_cutoff_freq=2 * 5.0, rwa_carrier_freqs=[5.0])
        return Solver(
            static_hamiltonian=2 * np.pi * 5.0 * Z / 2,
            hamiltonian_operators=[2 * np.pi * 0.1 * X / 2],
            rotating_frame=2 * np.pi * 5.0 * Z / 2,
            **kw,
        )

    def test_model_signals_unchanged_after_solve(self):
        solver = self._ham_solver()
        before = solver.model.signals
        solver.solve(
            t_span=[0.0, 0.5], y0=np.array([1.0, 0.0], dtype=complex),
            signals=[Signal(1.0, carrier_freq=5.0)],
            method="DOP853", atol=1e-10, rtol=1e-10,
        )
        assert solver.model.signals is before

    def test_rwa_solver_signals_translated(self):
        """An RWA solver given plain signals must agree with the full model
        solved without RWA (loose physics tolerance ~ rwa truncation)."""
        y0 = np.array([1.0, 0.0], dtype=complex)
        sig = [Signal(1.0, carrier_freq=5.0)]
        full = self._ham_solver(rwa=False).solve(
            t_span=[0.0, 2.0], y0=y0, signals=sig,
            method="DOP853", atol=1e-12, rtol=1e-12,
        )
        rwa = self._ham_solver(rwa=True).solve(
            t_span=[0.0, 2.0], y0=y0, signals=sig,
            method="DOP853", atol=1e-12, rtol=1e-12,
        )
        assert (
            np.max(np.abs(np.asarray(full.y[-1]) - np.asarray(rwa.y[-1]))) < 2e-2
        )

    def test_rwa_td_lindblad_signals_translated(self):
        """RWA Lindblad solver with time-dependent dissipator signals."""
        y0 = np.array([[1.0, 0.0], [0.0, 0.0]], dtype=complex)
        sm = np.array([[0.0, 1.0], [0.0, 0.0]], dtype=complex)
        sig = ([Signal(1.0, carrier_freq=5.0)], [Signal(0.05)])
        kw = dict(
            static_hamiltonian=2 * np.pi * 5.0 * Z / 2,
            hamiltonian_operators=[2 * np.pi * 0.1 * X / 2],
            dissipator_operators=[sm],
            rotating_frame=2 * np.pi * 5.0 * Z / 2,
        )
        full = Solver(**kw).solve(
            t_span=[0.0, 2.0], y0=y0, signals=sig,
            method="DOP853", atol=1e-12, rtol=1e-12,
        )
        rwa = Solver(
            rwa_cutoff_freq=2 * 5.0, rwa_carrier_freqs=([5.0], [0.0]), **kw
        ).solve(
            t_span=[0.0, 2.0], y0=y0, signals=sig,
            method="DOP853", atol=1e-12, rtol=1e-12,
        )
        assert (
            np.max(np.abs(np.asarray(full.y[-1]) - np.asarray(rwa.y[-1]))) < 2e-2
        )


class TestSolverListSimulationCases:
    """Broadcast combinations of t_span / y0 / signals lists (reference
    TestSolverListSimulation case1-4, test_solver_classes.py:1389-1600)."""

    def setup_method(self, method):
        self.solver = Solver(
            static_hamiltonian=2 * np.pi * 5.0 * Z / 2,
            hamiltonian_operators=[2 * np.pi * 0.1 * X / 2],
            rotating_frame=2 * np.pi * 5.0 * Z / 2,
        )
        self.y0a = np.array([1.0, 0.0], dtype=complex)
        self.y0b = np.array([0.0, 1.0], dtype=complex)
        self.sig_a = [Signal(0.5, carrier_freq=5.0)]
        self.sig_b = [Signal(1.0, carrier_freq=5.0)]
        self.kw = dict(method="DOP853", atol=1e-12, rtol=1e-12)

    def _single(self, t_span, y0, signals):
        return np.asarray(
            self.solver.solve(t_span=t_span, y0=y0, signals=signals, **self.kw).y[-1]
        )

    def test_t_span_list(self):
        res = self.solver.solve(
            t_span=[[0.0, 0.5], [0.0, 1.0]], y0=self.y0a, signals=self.sig_a, **self.kw
        )
        assert isinstance(res, list) and len(res) == 2
        for r, ts in zip(res, [[0.0, 0.5], [0.0, 1.0]]):
            np.testing.assert_allclose(
                np.asarray(r.y[-1]), self._single(ts, self.y0a, self.sig_a), atol=1e-10
            )

    def test_y0_list(self):
        res = self.solver.solve(
            t_span=[0.0, 0.5], y0=[self.y0a, self.y0b], signals=self.sig_a, **self.kw
        )
        assert isinstance(res, list) and len(res) == 2
        for r, y0 in zip(res, [self.y0a, self.y0b]):
            np.testing.assert_allclose(
                np.asarray(r.y[-1]), self._single([0.0, 0.5], y0, self.sig_a), atol=1e-10
            )

    def test_signals_list(self):
        res = self.solver.solve(
            t_span=[0.0, 0.5], y0=self.y0a, signals=[self.sig_a, self.sig_b], **self.kw
        )
        assert isinstance(res, list) and len(res) == 2
        for r, sg in zip(res, [self.sig_a, self.sig_b]):
            np.testing.assert_allclose(
                np.asarray(r.y[-1]), self._single([0.0, 0.5], self.y0a, sg), atol=1e-10
            )

    def test_all_lists(self):
        res = self.solver.solve(
            t_span=[[0.0, 0.5], [0.0, 1.0]],
            y0=[self.y0a, self.y0b],
            signals=[self.sig_a, self.sig_b],
            **self.kw,
        )
        assert isinstance(res, list) and len(res) == 2
        np.testing.assert_allclose(
            np.asarray(res[0].y[-1]),
            self._single([0.0, 0.5], self.y0a, self.sig_a), atol=1e-10,
        )
        np.testing.assert_allclose(
            np.asarray(res[1].y[-1]),
            self._single([0.0, 1.0], self.y0b, self.sig_b), atol=1e-10,
        )

    def test_mismatched_list_lengths_raise(self):
        with pytest.raises(Exception):
            self.solver.solve(
                t_span=[[0.0, 0.5]] * 3, y0=[self.y0a] * 2, signals=self.sig_a, **self.kw
            )


def test_schedule_channel_without_instructions():
    """A pulse-configured channel with no instructions in the schedule
    contributes zero drive (reference test_channel_without_instructions)."""
    from qiskit_dynamics_tpu.pulse import Schedule, Play, DriveChannel, Gaussian

    solver = Solver(
        static_hamiltonian=2 * np.pi * 5.0 * Z / 2,
        hamiltonian_operators=[2 * np.pi * 0.1 * X / 2, 2 * np.pi * 0.05 * Z / 2],
        hamiltonian_channels=["d0", "d1"],
        channel_carrier_freqs={"d0": 5.0, "d1": 4.5},
        dt=0.1,
        rotating_frame=2 * np.pi * 5.0 * Z / 2,
    )
    sched = Schedule()
    sched.append(Play(Gaussian(duration=20, amp=0.5, sigma=4), DriveChannel(0)))
    y0 = np.array([1.0, 0.0], dtype=complex)
    res_sched = solver.solve(
        t_span=[0.0, 2.0], y0=y0, signals=sched,
        method="DOP853", atol=1e-12, rtol=1e-12,
    )
    # manual equivalent: d0 from the converter, d1 identically zero
    sigs = solver._schedule_converter.get_signals(sched)
    assert len(sigs) >= 1
    manual = solver.solve(
        t_span=[0.0, 2.0], y0=y0,
        signals=[sigs[0], Signal(0.0, carrier_freq=4.5)],
        method="DOP853", atol=1e-12, rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(res_sched.y[-1]), np.asarray(manual.y[-1]), atol=1e-8
    )


class TestFusedScheduleSolveDF32:
    """precision='df32' serving: the schedule batch runs through the
    fixed-step df32 Magnus engine on a sample-aligned grid (VERDICT r4
    item 6 — the 1e-8-class serving mode)."""

    def test_df32_matches_high_accuracy_reference(self):
        solver = TestFusedScheduleSolve._pulse_solver()
        y0 = np.array([1.0, 0.0], dtype=complex)
        scheds = TestFusedScheduleSolve._schedules([0.3, 0.8])
        ref = solver.solve(
            t_span=[0.0, 4.0], y0=y0, signals=scheds, method="tpu_dopri5",
            atol=1e-13, rtol=1e-13, convert_results=False,
        )
        # no RWA here, so the post-frame generator oscillates at 2*NU = 10
        # (GHz-class): the 3-point Gauss rule needs <= ~0.13 cycles/step —
        # max_dt snaps to dt/8 = 0.0125 (measured 4.6e-7 at 0.05, 6th-order
        # convergence to ~1e-10 here)
        fused = solver.solve(
            t_span=[0.0, 4.0], y0=y0, signals=scheds, method="fused_dopri5",
            precision="df32", max_dt=0.0125, convert_results=False,
        )
        assert len(fused) == 2
        for a, b in zip(ref, fused):
            np.testing.assert_allclose(
                np.asarray(a.y[-1]), np.asarray(b.y[-1]), atol=1e-8
            )

    def test_df32_option_validation(self):
        solver = TestFusedScheduleSolve._pulse_solver()
        y0 = np.array([1.0, 0.0], dtype=complex)
        scheds = TestFusedScheduleSolve._schedules([0.5])
        with pytest.raises(DynamicsError, match="precision"):
            solver.solve(
                t_span=[0.0, 4.0], y0=y0, signals=scheds,
                method="fused_dopri5", precision="f16",
            )
        with pytest.raises(DynamicsError, match="df32"):
            solver.solve(
                t_span=[0.0, 4.0], y0=y0, signals=scheds,
                method="fused_dopri5", max_dt=0.05,
            )
        with pytest.raises(DynamicsError, match="df32"):
            solver.solve(
                t_span=[0.0, 4.0], y0=y0, signals=scheds,
                method="fused_dopri5", precision="df32", atol=1e-8,
            )
