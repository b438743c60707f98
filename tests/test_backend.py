"""Tests for the backend layer: string parser, measurement utils, DynamicsBackend.

Mirrors the reference's test strategy
(``/root/reference/test/dynamics/backend/``): validation error cases,
physics-level pi-pulse counts tests, measurement options.
"""
import numpy as np
import pytest

from qiskit_dynamics_tpu import Solver
from qiskit_dynamics_tpu.backend import (
    DynamicsBackend,
    parse_backend_hamiltonian_dict,
)
from qiskit_dynamics_tpu.backend.backend_utils import (
    _get_dressed_state_decomposition,
    _get_memory_slot_probabilities,
    _probabilities_dict,
    _get_iq_data,
)
from qiskit_dynamics_tpu.exceptions import DynamicsError
from qiskit_dynamics_tpu.pulse import (
    Schedule,
    Play,
    Acquire,
    DriveChannel,
    AcquireChannel,
    MemorySlot,
    Gaussian,
    Constant,
)
from qiskit_dynamics_tpu.quantum_info import Statevector, DensityMatrix


class TestStringParser:
    def test_single_transmon(self):
        ham = {
            "h_str": ["v*np.pi*O0", "alpha*np.pi*O0*O0", "r*np.pi*X0||D0"],
            "qub": {"0": 4},
            "vars": {"v": 2.1, "alpha": -0.33, "r": 0.02},
        }
        static, ops, channels, dims = parse_backend_hamiltonian_dict(ham)
        assert channels == ["d0"]
        assert dims == {0: 4}
        N = np.diag(np.arange(4))
        a = np.diag(np.sqrt(np.arange(1, 4)), 1)
        X = a + a.conj().T
        np.testing.assert_allclose(
            static, 2.1 * np.pi * N + (-0.33) * np.pi * N @ N, atol=1e-12
        )
        np.testing.assert_allclose(ops[0], 0.02 * np.pi * X, atol=1e-12)

    def test_two_transmon_sum_format(self):
        ham = {
            "h_str": [
                "_SUM[i,0,1,wq{i}/2*(I{i}-Z{i})]",
                "_SUM[i,0,1,delta{i}/2*O{i}*O{i}]",
                "_SUM[i,0,1,-delta{i}/2*O{i}]",
                "_SUM[i,0,1,omegad{i}*X{i}||D{i}]",
                "jq0q1*Sp0*Sm1",
                "jq0q1*Sm0*Sp1",
            ],
            "qub": {"0": 3, "1": 3},
            "vars": {
                "wq0": 32.5,
                "wq1": 33.1,
                "delta0": -2.1,
                "delta1": -2.09,
                "jq0q1": 0.01,
                "omegad0": 0.97,
                "omegad1": 0.98,
            },
        }
        static, ops, channels, dims = parse_backend_hamiltonian_dict(ham)
        assert channels == ["d0", "d1"]
        assert dims == {0: 3, 1: 3}
        assert static.shape == (9, 9)
        # hermiticity of static part
        np.testing.assert_allclose(static, static.conj().T, atol=1e-12)
        # subsystem 0 operator should be I tensor X (little-endian: sub 0 last)
        a = np.diag(np.sqrt(np.arange(1, 3)), 1)
        X3 = a + a.conj().T
        np.testing.assert_allclose(ops[0], 0.97 * np.kron(np.eye(3), X3), atol=1e-12)
        np.testing.assert_allclose(ops[1], 0.98 * np.kron(X3, np.eye(3)), atol=1e-12)

    def test_subsystem_filtering(self):
        ham = {
            "h_str": ["w0*N0", "w1*N1", "j*Sp0*Sm1", "r*X0||D0", "r*X1||D1"],
            "qub": {"0": 2, "1": 2},
            "vars": {"w0": 5.0, "w1": 5.1, "j": 0.01, "r": 0.02},
        }
        static, ops, channels, dims = parse_backend_hamiltonian_dict(ham, subsystem_list=[0])
        assert channels == ["d0"]
        assert dims == {0: 2}
        assert static.shape == (2, 2)
        np.testing.assert_allclose(static, 5.0 * np.diag([0.0, 1.0]), atol=1e-12)

    def test_dag(self):
        ham = {
            "h_str": ["r*(Sm0+Sm0.dag)||D0"],
            "qub": {"0": 2},
            "vars": {"r": 0.5},
        }
        _, ops, _, _ = parse_backend_hamiltonian_dict(ham)
        np.testing.assert_allclose(ops[0], 0.5 * np.array([[0, 1], [1, 0]]), atol=1e-12)

    def test_validation_errors(self):
        with pytest.raises(DynamicsError):
            parse_backend_hamiltonian_dict({"h_str": [], "qub": {"0": 2}})
        with pytest.raises(DynamicsError):
            parse_backend_hamiltonian_dict({"h_str": ["X0"], "qub": {}})
        with pytest.raises(DynamicsError):
            parse_backend_hamiltonian_dict(
                {"h_str": ["r*X0||"], "qub": {"0": 2}, "vars": {"r": 1.0}}
            )


class TestBackendUtils:
    def test_dressed_state_decomposition(self):
        H = np.diag([0.0, 1.0, 5.0]) + 0.01 * np.ones((3, 3))
        evals, states = _get_dressed_state_decomposition(H)
        # each dressed state dominated by its elementary component
        for i in range(3):
            assert np.argmax(np.abs(states[:, i])) == i
        # reconstruction
        np.testing.assert_allclose(
            states @ np.diag(evals) @ states.conj().T, H, atol=1e-10
        )

    def test_dressed_non_hermitian_raises(self):
        with pytest.raises(DynamicsError):
            _get_dressed_state_decomposition(np.array([[0.0, 1.0], [0.0, 0.0]]))

    def test_probabilities_dict(self):
        # two qubits: state |01> (sub0=1, sub1=0)
        probs = np.zeros(4)
        probs[1] = 1.0  # index 1 = (sub1=0, sub0=1) little endian
        d = _probabilities_dict(probs, (2, 2), qargs=[0, 1])
        assert d == {"01": 1.0}
        d0 = _probabilities_dict(probs, (2, 2), qargs=[0])
        assert d0 == {"1": 1.0}
        d1 = _probabilities_dict(probs, (2, 2), qargs=[1])
        assert d1 == {"0": 1.0}

    def test_memory_slot_probabilities(self):
        probs = {"02": 0.3, "10": 0.7}
        out = _get_memory_slot_probabilities(
            probs, memory_slot_indices=[0, 1], num_memory_slots=2, max_outcome_value=1
        )
        # "02": slot0 <- '2'->'1', slot1 <- '0' => "01"; "10": slot0 <- 0, slot1 <- 1 => "10"
        assert out == {"01": 0.3, "10": 0.7}

    def test_iq_data_shape(self):
        state = Statevector([1.0, 0.0], dims=(2,))
        iq = _get_iq_data(
            state,
            measurement_subsystems=[0],
            iq_centers=[[[1, 0], [-1, 0]]],
            iq_width=0.1,
            shots=100,
            memory_slot_indices=[0],
            seed=5,
        )
        assert iq.shape == (100, 1, 2)
        assert np.abs(iq[:, 0, 0].mean() - 1.0) < 0.1


def _rabi_backend(**options):
    """2-level solver configured for pulse simulation of a d0 drive."""
    nu = 5.0
    X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
    Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
    r = 0.1
    solver = Solver(
        static_hamiltonian=2 * np.pi * nu * Z / 2,
        hamiltonian_operators=[2 * np.pi * r * X / 2],
        hamiltonian_channels=["d0"],
        channel_carrier_freqs={"d0": nu},
        dt=0.1,
        rotating_frame=2 * np.pi * nu * Z / 2,
    )
    return DynamicsBackend(solver=solver, subsystem_dims=[2], **options), r


class TestMeasurementOptions:
    """Behavioral coverage of the measurement-pipeline options (reference
    analog: test_dynamics_backend.py measurement-option battery)."""

    @staticmethod
    def _pi_half_schedule(r, n_samples=25):
        amp = 1.0 / (r * 50 * 0.1)  # pi amplitude at 50 samples -> pi/2 at 25
        sched = Schedule(name="pi_half")
        sched.append(Play(Constant(duration=n_samples, amp=amp), DriveChannel(0)))
        sched.insert(n_samples, Acquire(1, AcquireChannel(0), MemorySlot(0)))
        return sched

    def test_memory_contents(self):
        """memory=True: per-shot outcome strings consistent with counts."""
        backend, r = _rabi_backend(seed_simulator=7, shots=64)
        res = backend.run(self._pi_half_schedule(r)).result()
        counts = res.get_counts()
        mem = res.get_memory()
        assert len(mem) == 64
        from collections import Counter

        assert Counter(mem) == Counter(
            {k: v for k, v in counts.items()}
        )

    def test_memory_disabled(self):
        backend, r = _rabi_backend(seed_simulator=7, shots=16, memory=False)
        res = backend.run(self._pi_half_schedule(r)).result()
        with pytest.raises(Exception):
            res.get_memory()

    def test_seed_reproducibility(self):
        b1, r = _rabi_backend(seed_simulator=11, shots=128)
        b2, _ = _rabi_backend(seed_simulator=11, shots=128)
        sched = self._pi_half_schedule(r)
        assert b1.run(sched).result().get_counts() == b2.run(sched).result().get_counts()

    def test_max_outcome_level_clips(self):
        """max_outcome_level=1 restricts count keys to binary outcomes."""
        backend, r = _rabi_backend(seed_simulator=5, shots=256, max_outcome_level=1)
        res = backend.run(self._pi_half_schedule(r)).result()
        assert set(res.get_counts()) <= {"0", "1"}

    def test_meas_level_1_avg_vs_single(self):
        backend, r = _rabi_backend(
            seed_simulator=5, shots=100, meas_level=1, meas_return="single"
        )
        sched = self._pi_half_schedule(r)
        res_single = backend.run(sched).result()
        single = np.asarray(res_single.get_memory())
        assert single.shape == (100, 1, 2)
        backend.set_options(meas_return="avg")
        res_avg = backend.run(sched).result()
        avg = np.asarray(res_avg.get_memory())
        assert avg.shape == (1, 2)

    def test_iq_centers_respected(self):
        """Custom iq_centers relocate the measurement clouds."""
        centers = [[(5.0, 5.0), (-5.0, -5.0)]]
        backend, r = _rabi_backend(
            seed_simulator=5, shots=200, meas_level=1, meas_return="single",
            iq_centers=centers, iq_width=0.1,
        )
        # no pulse: ground state -> cloud at centers[0][0] = (5, 5)
        sched = Schedule(name="idle")
        sched.insert(4, Acquire(1, AcquireChannel(0), MemorySlot(0)))
        res = backend.run(sched).result()
        iq = np.asarray(res.get_memory())
        assert abs(iq[:, 0, 0].mean() - 5.0) < 0.1
        assert abs(iq[:, 0, 1].mean() - 5.0) < 0.1

    def test_initial_state_option(self):
        """initial_state: starting in |1> with no pulse measures 1."""
        backend, r = _rabi_backend(seed_simulator=5, shots=64)
        backend.set_options(initial_state=Statevector([0.0, 1.0]))
        sched = Schedule(name="idle")
        sched.insert(4, Acquire(1, AcquireChannel(0), MemorySlot(0)))
        counts = backend.run(sched).result().get_counts()
        assert counts == {"1": 64}

    def test_normalize_states_off(self):
        """normalize_states=False skips renormalization everywhere — sampling
        then requires the raw probabilities to sum to 1 (reference-matching:
        a drifted solve raises from numpy's choice). Use a tight solve."""
        backend, r = _rabi_backend(
            seed_simulator=5, shots=32, normalize_states=False,
            solver_options={"method": "DOP853", "atol": 1e-13, "rtol": 1e-13},
        )
        res = backend.run(self._pi_half_schedule(r)).result()
        assert sum(res.get_counts().values()) == 32


class TestDynamicsBackend:
    def test_pi_pulse_counts(self):
        backend, r = _rabi_backend(seed_simulator=42)
        # constant pulse implementing a pi rotation: amp * r * duration * dt = 1
        n_samples = 50
        amp = 1.0 / (r * n_samples * 0.1)
        sched = Schedule(name="pi_pulse")
        sched.append(Play(Constant(duration=n_samples, amp=amp), DriveChannel(0)))
        sched.insert(n_samples, Acquire(1, AcquireChannel(0), MemorySlot(0)))

        res = backend.run(sched, solver_options={"method": "DOP853", "atol": 1e-10, "rtol": 1e-10}).result()
        counts = res.get_counts()
        assert counts.get("1", 0) > 1000  # nearly all shots in |1>

    def test_no_pulse_ground_state(self):
        backend, _ = _rabi_backend(seed_simulator=3)
        sched = Schedule(name="idle")
        sched.append(Acquire(1, AcquireChannel(0), MemorySlot(0)))
        sched.insert(100, Acquire(1, AcquireChannel(0), MemorySlot(0)))
        with pytest.raises(DynamicsError):
            # measurements at two different times unsupported
            backend.run(sched)

        sched2 = Schedule(name="idle2")
        sched2.insert(100, Acquire(1, AcquireChannel(0), MemorySlot(0)))
        res = backend.run(sched2).result()
        assert res.get_counts() == {"0": 1024}

    def test_meas_level_1(self):
        backend, r = _rabi_backend(seed_simulator=7, meas_level=1, meas_return="single")
        sched = Schedule(name="iq")
        sched.insert(10, Acquire(1, AcquireChannel(0), MemorySlot(0)))
        res = backend.run(sched).result()
        iq = res.get_memory()
        assert iq.shape == (1024, 1, 2)
        # ground state: centered near (1, 0)
        assert abs(iq[:, 0, 0].mean() - 1.0) < 0.05

    def test_solve_passthrough(self):
        backend, r = _rabi_backend()
        sched = Schedule(name="s")
        sched.append(Play(Constant(duration=10, amp=0.1), DriveChannel(0)))
        sched.insert(10, Acquire(1, AcquireChannel(0), MemorySlot(0)))
        out = backend.solve(sched, y0=Statevector([1.0, 0.0]))
        if isinstance(out, list):
            out = out[0]
        assert hasattr(out, "y")
        assert isinstance(out.y[-1], Statevector)

    def test_option_validation(self):
        backend, _ = _rabi_backend()
        with pytest.raises(DynamicsError):
            backend.set_options(meas_level=3)
        with pytest.raises(DynamicsError):
            backend.set_options(meas_return="bad")
        with pytest.raises(DynamicsError):
            backend.set_options(max_outcome_level=0)
        with pytest.raises(DynamicsError):
            backend.set_options(iq_width=-1.0)
        with pytest.raises(DynamicsError):
            backend.set_options(initial_state="bad_string")
        with pytest.raises(AttributeError):
            backend.set_options(nonexistent_option=1)

    def test_subsystem_dims_validation(self):
        nu = 5.0
        Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
        X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
        solver = Solver(
            static_hamiltonian=2 * np.pi * nu * Z / 2,
            hamiltonian_operators=[2 * np.pi * X / 2],
            hamiltonian_channels=["d0"],
            channel_carrier_freqs={"d0": nu},
            dt=0.1,
            rotating_frame=None,
        )
        with pytest.raises(DynamicsError):
            DynamicsBackend(solver=solver, subsystem_dims=[3])

    def test_unconfigured_solver_rejected(self):
        Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
        solver = Solver(static_hamiltonian=Z)
        with pytest.raises(DynamicsError):
            DynamicsBackend(solver=solver)

    def test_from_config(self):
        ham = {
            "h_str": ["v*np.pi*(I0-Z0)", "r*np.pi*X0||D0"],
            "qub": {"0": 2},
            "vars": {"v": 5.0, "r": 0.1},
        }
        backend = DynamicsBackend.from_config(
            hamiltonian_dict=ham,
            dt=0.1,
            channel_carrier_freqs={"d0": 5.0},
            seed_simulator=11,
        )
        assert backend.options.subsystem_dims == [2]
        sched = Schedule(name="idle")
        sched.insert(10, Acquire(1, AcquireChannel(0), MemorySlot(0)))
        res = backend.run(sched).result()
        assert res.get_counts() == {"0": 1024}


class TestThreeTransmonConfig:
    """BASELINE config 5: 3-transmon chip via from_config + schedule batch."""

    def test_amp_sweep_counts(self):
        from qiskit_dynamics_tpu.benchmarks import (
            gaussian_amp_schedules,
            three_transmon_backend,
        )

        backend = three_transmon_backend(dim=2)
        scheds = gaussian_amp_schedules([0.1, 2.0], duration=32)
        res = backend.run(
            scheds, seed_simulator=5,
            solver_options={"method": "DOP853", "atol": 1e-8, "rtol": 1e-8},
        ).result()
        weak, strong = res.get_counts(0), res.get_counts(1)
        # qiskit parity: no-index get_counts on a multi-experiment result
        # returns the list of counts dicts
        assert res.get_counts() == [weak, strong]
        assert sum(weak.values()) == 1024
        assert all(len(key) == 3 for key in weak)
        # stronger drive on d0 excites qubit 0 (rightmost slot) more
        assert strong.get("001", 0) > weak.get("001", 0)

    def test_schedule_batch_jax_path(self):
        from qiskit_dynamics_tpu.benchmarks import (
            gaussian_amp_schedules,
            three_transmon_backend,
        )

        backend = three_transmon_backend(dim=2)
        scheds = gaussian_amp_schedules([0.3, 0.9], duration=32)
        res_jax = backend.solve(scheds)
        def solve_one(s):
            out = backend.solve(s, t_span=[0.0, s.duration * backend.dt])
            return out[0] if isinstance(out, list) else out

        res_ref = [solve_one(s) for s in scheds]
        for rj, rr in zip(res_jax, res_ref):
            np.testing.assert_allclose(
                np.asarray(rj.y[-1]), np.asarray(rr.y[-1]), atol=1e-5
            )

    def test_schedule_batch_fused_path(self):
        """solver_options={'method': 'fused_dopri5'}: the whole schedule batch
        runs in ONE fused adaptive engine call (the serving path)."""
        from qiskit_dynamics_tpu.benchmarks import (
            gaussian_amp_schedules,
            three_transmon_backend,
        )

        backend = three_transmon_backend(dim=2)
        scheds = gaussian_amp_schedules([0.3, 0.9], duration=32)
        backend.set_options(
            solver_options={"method": "tpu_dopri5", "atol": 1e-12, "rtol": 1e-12}
        )
        res_ref = backend.solve(scheds)
        backend.set_options(
            solver_options={"method": "fused_dopri5", "interpret": True}
        )
        res_fused = backend.solve(scheds)
        for rf, rr in zip(res_fused, res_ref):
            # the f32 lockstep engine sits well inside 1e-4 of the tight
            # reference; the backend's DEFAULT path is ~7e-4 from it
            np.testing.assert_allclose(
                np.asarray(rf.y[-1]), np.asarray(rr.y[-1]), atol=1e-4
            )

    def test_run_counts_fused_path(self):
        """backend.run -> counts through the fused engine matches physics."""
        from qiskit_dynamics_tpu.benchmarks import (
            gaussian_amp_schedules,
            three_transmon_backend,
        )

        backend = three_transmon_backend(dim=2)
        backend.set_options(
            solver_options={"method": "fused_dopri5", "interpret": True},
            shots=512, seed_simulator=42,
        )
        weak, strong = gaussian_amp_schedules([0.05, 0.9], duration=32)
        res = backend.run([weak, strong]).result()
        cw = res.get_counts(0)
        cs = res.get_counts(1)
        assert sum(cw.values()) == 512
        assert cs.get("001", 0) > cw.get("001", 0)


class TestChannelAccessors:
    def test_channels(self):
        backend, _ = _rabi_backend(control_channel_map={(0, 1): 3})
        assert backend.drive_channel(0).name == "d0"
        assert backend.measure_channel(0).name == "m0"
        assert backend.acquire_channel(0).name == "a0"
        assert backend.control_channel((0, 1))[0].name == "u3"
        with pytest.raises(DynamicsError):
            backend.drive_channel(5)
        with pytest.raises(DynamicsError):
            backend.control_channel((1, 0))

    def test_control_channel_unset(self):
        backend, _ = _rabi_backend()
        with pytest.raises(NotImplementedError):
            backend.control_channel((0, 1))


class TestTwoQubitCounts:
    def test_two_transmon_idle_counts(self):
        ham = {
            "h_str": [
                "_SUM[i,0,1,w{i}*N{i}]",
                "j*Sp0*Sm1", "j*Sm0*Sp1",
                "r*X0||D0", "r*X1||D1",
            ],
            "qub": {"0": 2, "1": 2},
            "vars": {"w0": 31.4, "w1": 32.0, "j": 0.01, "r": 0.6},
        }
        backend = DynamicsBackend.from_config(
            hamiltonian_dict=ham, dt=0.1,
            channel_carrier_freqs={"d0": 31.4 / (2 * np.pi), "d1": 32.0 / (2 * np.pi)},
            seed_simulator=5,
        )
        sched = Schedule(name="idle2q")
        sched.insert(20, Acquire(1, AcquireChannel(0), MemorySlot(0)))
        sched.insert(20, Acquire(1, AcquireChannel(1), MemorySlot(1)))
        counts = backend.run(sched).result().get_counts()
        assert counts == {"00": 1024}


class TestRunValidation:
    """run-input and schedule-shape validation battery (reference
    test_dynamics_backend.py validation families)."""

    def test_run_input_type_error(self):
        backend, _ = _rabi_backend()
        with pytest.raises(DynamicsError, match="not supported"):
            backend.run(3.14)

    def test_no_measurement_in_schedule(self):
        backend, _ = _rabi_backend()
        sched = Schedule(Play(Constant(duration=8, amp=0.1), DriveChannel(0)))
        with pytest.raises(DynamicsError, match="MemorySlot"):
            backend.run(sched)

    def test_measurements_at_different_times_rejected(self):
        backend, _ = _rabi_backend()
        sched = Schedule(Play(Constant(duration=8, amp=0.1), DriveChannel(0)))
        sched.insert(8, Acquire(1, AcquireChannel(0), MemorySlot(0)))
        sched.insert(12, Acquire(1, AcquireChannel(0), MemorySlot(1)))
        with pytest.raises(DynamicsError, match="one time"):
            backend.run(sched)

    def test_measure_out_of_bounds_subsystem(self):
        backend, _ = _rabi_backend()
        sched = Schedule(Play(Constant(duration=8, amp=0.1), DriveChannel(0)))
        sched.insert(8, Acquire(1, AcquireChannel(3), MemorySlot(0)))
        with pytest.raises(DynamicsError, match="out of bounds"):
            backend.run(sched)

    def test_memory_slot_num_sets_result_width(self):
        # memory slot index 2 -> counts keys are 3 characters wide
        backend, r = _rabi_backend(seed_simulator=3, shots=32)
        sched = Schedule(Play(Constant(duration=8, amp=0.01), DriveChannel(0)))
        sched.insert(8, Acquire(1, AcquireChannel(0), MemorySlot(2)))
        counts = backend.run(sched).result().get_counts()
        assert all(len(k) == 3 for k in counts)

    def test_experiment_result_function_override(self):
        calls = []

        def custom_fn(experiment_name, solver_result, measurement_subsystems,
                      memory_slot_indices, num_memory_slots, backend, seed, metadata):
            calls.append(experiment_name)
            from qiskit_dynamics_tpu.backend.dynamics_backend import (
                default_experiment_result_function,
            )
            return default_experiment_result_function(
                experiment_name, solver_result, measurement_subsystems,
                memory_slot_indices, num_memory_slots, backend, seed, metadata,
            )

        backend, r = _rabi_backend(
            seed_simulator=1, shots=16, experiment_result_function=custom_fn
        )
        sched = Schedule(name="custom")
        sched.append(Play(Constant(duration=8, amp=0.01), DriveChannel(0)))
        sched.insert(8, Acquire(1, AcquireChannel(0), MemorySlot(0)))
        res = backend.run(sched).result()
        assert calls == ["custom"]
        assert res.results[0].header.name == "custom"

    def test_metadata_transfer(self):
        backend, _ = _rabi_backend(seed_simulator=1, shots=8)
        sched = Schedule(name="meta_sched")
        sched.append(Play(Constant(duration=8, amp=0.01), DriveChannel(0)))
        sched.insert(8, Acquire(1, AcquireChannel(0), MemorySlot(0)))
        sched.metadata = {"my_key": 42}
        res = backend.run(sched).result()
        assert res.results[0].header.metadata == {"my_key": 42}

    def test_trivial_subsystem_measure_warns(self):
        nu = 5.0
        Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
        X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
        solver = Solver(
            static_hamiltonian=2 * np.pi * nu * Z / 2,
            hamiltonian_operators=[2 * np.pi * 0.1 * X / 2],
            hamiltonian_channels=["d0"],
            channel_carrier_freqs={"d0": nu},
            dt=0.1,
        )
        backend = DynamicsBackend(
            solver=solver, subsystem_dims=[2, 1], seed_simulator=1, shots=8
        )
        sched = Schedule(Play(Constant(duration=8, amp=0.01), DriveChannel(0)))
        sched.insert(8, Acquire(1, AcquireChannel(1), MemorySlot(0)))
        with pytest.warns(UserWarning, match="trivial"):
            backend.run(sched)


class TestBackendUtilsBattery:
    """Extended backend_utils behaviors (reference test_backend_utils.py):
    dressed-state reordering and degeneracy failure, lab-frame static
    Hamiltonian recovery across frame types, memory-slot edge cases, and
    subsystem marginals."""

    def test_dressed_reordering(self):
        from qiskit_dynamics_tpu.backend.backend_utils import (
            _get_dressed_state_decomposition,
        )

        # eigh returns ascending eigenvalues; position sorting must undo it
        H = np.diag([3.0, 1.0, 2.0]) + 0.01 * (np.ones((3, 3)) - np.eye(3))
        evals, evecs = _get_dressed_state_decomposition(H)
        # dressed_evals[j] tracks the basis state j, not the sorted order
        assert abs(evals[0] - 3.0) < 0.05
        assert abs(evals[1] - 1.0) < 0.05
        assert abs(evals[2] - 2.0) < 0.05
        for j in range(3):
            assert int(np.argmax(np.abs(evecs[:, j]))) == j

    def test_dressed_degenerate_raises(self):
        from qiskit_dynamics_tpu.backend.backend_utils import (
            _get_dressed_state_decomposition,
        )
        from qiskit_dynamics_tpu.exceptions import DynamicsError

        # maximal mixing: both eigenvectors have the same dominant component
        X = np.array([[0.0, 1.0], [1.0, 0.0]])
        with pytest.raises(DynamicsError, match="sorting failed"):
            _get_dressed_state_decomposition(X)

    @pytest.mark.parametrize("frame", [None, "diag", "operator"])
    def test_lab_frame_static_hamiltonian_recovery(self, frame):
        from qiskit_dynamics_tpu.backend.backend_utils import (
            _get_lab_frame_static_hamiltonian,
        )
        from qiskit_dynamics_tpu.models import HamiltonianModel

        H = 2 * np.pi * np.diag([0.0, 5.0, 9.8]) + 0.1 * (
            np.diag([1.0, 1.0], 1) + np.diag([1.0, 1.0], -1)
        )
        frame_op = {
            None: None,
            "diag": np.diag(H).copy(),
            "operator": H,
        }[frame]
        model = HamiltonianModel(
            operators=[np.diag([1.0, -1.0, 0.0])],
            static_operator=H,
            rotating_frame=frame_op,
        )
        recovered = _get_lab_frame_static_hamiltonian(model)
        np.testing.assert_allclose(recovered, H, atol=1e-10)

    def test_lab_frame_static_hamiltonian_lindblad(self):
        from qiskit_dynamics_tpu.backend.backend_utils import (
            _get_lab_frame_static_hamiltonian,
        )
        from qiskit_dynamics_tpu.models import LindbladModel

        H = 2 * np.pi * 5.0 * np.diag([-0.5, 0.5])
        sm = np.array([[0.0, 1.0], [0.0, 0.0]], dtype=complex)
        model = LindbladModel(
            static_hamiltonian=H,
            static_dissipators=[0.1 * sm],
            rotating_frame=H,
        )
        np.testing.assert_allclose(
            _get_lab_frame_static_hamiltonian(model), H, atol=1e-10
        )

    def test_memory_slots_extra_slots(self):
        from qiskit_dynamics_tpu.backend.backend_utils import (
            _get_memory_slot_probabilities,
        )

        probs = {"10": 0.7, "01": 0.3}
        # subsystem 0 -> slot 0, subsystem 1 -> slot 2, 4 slots total
        out = _get_memory_slot_probabilities(probs, [0, 2], num_memory_slots=4)
        assert out == {"0100": 0.7, "0001": 0.3}

    def test_memory_slots_outcome_bound_merges(self):
        from qiskit_dynamics_tpu.backend.backend_utils import (
            _get_memory_slot_probabilities,
        )

        # levels 2 and 1 both round down to 1 -> probabilities merge
        probs = {"2": 0.25, "1": 0.35, "0": 0.4}
        out = _get_memory_slot_probabilities(probs, [0], max_outcome_value=1)
        assert abs(out["1"] - 0.6) < 1e-13 and abs(out["0"] - 0.4) < 1e-13

    def test_subsystem_probabilities(self):
        from qiskit_dynamics_tpu.backend.backend_utils import (
            _get_subsystem_probabilities,
        )

        # two qubits: P(q0=1) and P(q1=1) marginals of a product state
        p0 = np.array([0.8, 0.2])
        p1 = np.array([0.3, 0.7])
        # tensor with dims reversed-qiskit convention: index (q1, q0)
        joint = np.einsum("a,b->ab", p1, p0)
        marg0 = _get_subsystem_probabilities(joint, 0)
        marg1 = _get_subsystem_probabilities(joint, 1)
        np.testing.assert_allclose(marg0, p0, atol=1e-13)
        np.testing.assert_allclose(marg1, p1, atol=1e-13)
