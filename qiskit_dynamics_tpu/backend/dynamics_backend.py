"""Pulse-level simulator backend (the serving layer).

Reference behavior: ``/root/reference/qiskit_dynamics/backend/dynamics_backend.py``.

Wraps a pulse-configured :class:`Solver` behind a backend interface: takes
pulse schedules (native :class:`Schedule` or qiskit ``Schedule``/
``ScheduleBlock`` when qiskit is installed), simulates them, and produces
counts or IQ data through the dressed-basis measurement pipeline. Options
mirror the reference's supported set (shots, meas_level/meas_return,
iq_centers/iq_width, max_outcome_level, memory, seed_simulator,
experiment_result_function, initial_state, normalize_states, solver_options,
subsystem_dims, meas_map, control_channel_map).
"""
from __future__ import annotations

import copy
import datetime
import uuid
import warnings
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..exceptions import DynamicsError
from ..quantum_info import Statevector, DensityMatrix
from ..pulse import Schedule, Acquire, block_to_schedule
from ..pulse.schedule import AcquireChannel, MemorySlot
from ..solvers import Solver, OdeResult
from .backend_utils import (
    _get_dressed_state_decomposition,
    _get_lab_frame_static_hamiltonian,
    _get_memory_slot_probabilities,
    _sample_probability_dict,
    _get_counts_from_samples,
    _get_iq_data,
    _probabilities_dict,
)
from .dynamics_job import DynamicsJob
from .results import ExperimentResult, ExperimentResultData, Result
from .string_parser import parse_backend_hamiltonian_dict

__all__ = ["DynamicsBackend", "default_experiment_result_function"]


class _Options(SimpleNamespace):
    """Attribute-access options container."""

    def update_options(self, **fields):
        self.__dict__.update(fields)


def _is_native_or_qiskit_schedule(x) -> bool:
    if isinstance(x, Schedule) or _is_circuit_like(x):
        return True
    try:
        from qiskit import pulse as qiskit_pulse

        return isinstance(x, (qiskit_pulse.Schedule, qiskit_pulse.ScheduleBlock))
    except ImportError:
        return False


def _validate_run_input(run_input, accept_list: bool = True):
    if isinstance(run_input, list) and accept_list:
        for x in run_input:
            _validate_run_input(x, accept_list=False)
    elif not _is_native_or_qiskit_schedule(run_input):
        raise DynamicsError(f"Input type {type(run_input)} not supported by DynamicsBackend.")


def _is_circuit_like(obj) -> bool:
    """QuantumCircuit shape: instruction list + calibrations + cregs."""
    return (
        hasattr(obj, "data") and hasattr(obj, "calibrations") and hasattr(obj, "cregs")
    )


def _qubit_index(circuit, qubit) -> int:
    """Resolve a circuit qubit reference to an integer index."""
    if isinstance(qubit, (int, np.integer)):
        return int(qubit)
    find_bit = getattr(circuit, "find_bit", None)
    if callable(find_bit):
        return int(find_bit(qubit).index)
    idx = getattr(qubit, "index", None)
    if idx is not None:
        return int(idx)
    raise DynamicsError(f"Cannot resolve qubit index for {qubit!r}.")


def _lookup_calibration(circuit, name: str, qubits: Tuple[int, ...], params):
    """Fetch a calibration schedule for (gate, qubits, params) if present."""
    table = circuit.calibrations.get(name)
    if not table:
        return None
    key = (tuple(qubits), tuple(params))
    if key in table:
        return table[key]
    # parameter-free lookup fallback (calibration registered without params)
    for (cal_qubits, _), sched in table.items():
        if tuple(cal_qubits) == tuple(qubits):
            return sched
    return None


def _circuit_to_schedule(circuit, backend=None) -> Schedule:
    """Lower a circuit to a native Schedule via its calibration table.

    The reference delegates to qiskit's transpile/``build_schedule``
    (``dynamics_backend.py:429, 1022-1044``); when qiskit is importable and
    the input is a real ``QuantumCircuit`` that path is used. The native
    lowering here is a minimal ASAP scheduler: per-qubit clocks advance
    through the circuit in order; each gate must have an entry in
    ``circuit.calibrations`` (a native Schedule); ``measure`` uses its
    calibration when present and otherwise synthesizes a one-sample
    ``Acquire`` on the qubit's acquire channel; ``barrier`` synchronizes the
    involved qubits' clocks.
    """
    try:  # real qiskit circuit -> use qiskit's scheduler (full semantics)
        from qiskit import QuantumCircuit
        from qiskit.pulse import build_schedule

        if isinstance(circuit, QuantumCircuit):
            dt = backend.options.solver._dt if backend is not None else None
            return build_schedule(circuit, backend, dt=dt)
    except ImportError:
        pass

    num_qubits = int(getattr(circuit, "num_qubits", 0))
    clocks = [0] * max(num_qubits, 1)
    sched = Schedule(name=getattr(circuit, "name", None))
    for item in circuit.data:
        op = getattr(item, "operation", item)
        name = op.name
        qubits = [_qubit_index(circuit, q) for q in item.qubits]
        while max(qubits, default=0) >= len(clocks):
            clocks.append(0)
        start = max((clocks[q] for q in qubits), default=0)
        if name == "barrier":
            for q in qubits or range(len(clocks)):
                clocks[q] = start
            continue
        if name == "measure":
            cal = _lookup_calibration(circuit, "measure", tuple(qubits), ())
            clbits = [_qubit_index(circuit, c) for c in getattr(item, "clbits", [])]
            if cal is not None:
                for t, inst in cal.instructions:
                    sched.insert(start + t, inst, inplace=True)
                dur = cal.duration
            else:
                dur = 1
                for q, c in zip(qubits, clbits or qubits):
                    sched.insert(
                        start,
                        Acquire(dur, AcquireChannel(q), mem_slot=MemorySlot(c)),
                        inplace=True,
                    )
            for q in qubits:
                clocks[q] = start + dur
            continue
        cal = _lookup_calibration(circuit, name, tuple(qubits), getattr(op, "params", ()))
        if cal is None:
            raise DynamicsError(
                f"Circuit instruction '{name}' on qubits {qubits} has no calibration; "
                "native circuit lowering requires a calibration schedule per gate."
            )
        for t, inst in cal.instructions:
            sched.insert(start + t, inst, inplace=True)
        for q in qubits:
            clocks[q] = start + cal.duration
    return sched


def _to_schedule_list(run_input, backend=None) -> Tuple[List[Schedule], List[Optional[int]]]:
    """Normalize inputs to native/qiskit Schedules; track circuit memslot counts."""
    if not isinstance(run_input, list):
        run_input = [run_input]
    schedules, num_memslots = [], []
    for sched in run_input:
        num_memslots.append(None)
        if isinstance(sched, Schedule):
            schedules.append(sched)
            continue
        if _is_circuit_like(sched):
            num_memslots[-1] = sum(creg.size for creg in sched.cregs) or None
            schedules.append(_circuit_to_schedule(sched, backend))
            continue
        try:
            from qiskit import pulse as qiskit_pulse

            if isinstance(sched, qiskit_pulse.ScheduleBlock):
                schedules.append(block_to_schedule(sched))
                continue
            if isinstance(sched, qiskit_pulse.Schedule):
                schedules.append(sched)
                continue
        except ImportError:
            pass
        raise DynamicsError(f"Type {type(sched)} cannot be converted to Schedule.")
    return schedules, num_memslots


def _get_acquire_instruction_timings(
    schedules: List[Schedule], subsystem_dims: List[int], dt: float
) -> Tuple[List[List[float]], List[List[int]], List[List[int]]]:
    """Extract per-schedule integration spans and measurement layout from the
    Acquire instructions (all acquires in a schedule must share a start time)."""
    t_span_list, measurement_subsystems_list, memory_slot_indices_list = [], [], []
    for schedule in schedules:
        acquires, acquire_times = [], []
        for start_time, inst in schedule.instructions:
            is_acquire = isinstance(inst, Acquire) or type(inst).__name__ == "Acquire"
            if is_acquire and getattr(inst, "mem_slot", None) is not None:
                acquires.append(inst)
                acquire_times.append(start_time)

        if not acquire_times:
            raise DynamicsError(
                "At least one measurement saving a result in a MemorySlot must be present "
                "in each schedule."
            )
        if any(t != acquire_times[0] for t in acquire_times[1:]):
            raise DynamicsError("DynamicsBackend.run only supports measurements at one time.")

        t_span_list.append([0.0, dt * acquire_times[0]])
        measurement_subsystems, memory_slot_indices = [], []
        for inst in acquires:
            idx = inst.channel.index
            if not idx < len(subsystem_dims):
                raise DynamicsError(f"Attempted to measure out of bounds subsystem {idx}.")
            if subsystem_dims[idx] == 1:
                warnings.warn(f"Measuring trivial subsystem {idx} with dimension 1.")
            measurement_subsystems.append(idx)
            memory_slot_indices.append(inst.mem_slot.index)
        measurement_subsystems_list.append(measurement_subsystems)
        memory_slot_indices_list.append(memory_slot_indices)
    return t_span_list, measurement_subsystems_list, memory_slot_indices_list


class DynamicsBackend:
    """Pulse-level simulator backend around a pulse-configured :class:`Solver`.

    ``solver_options`` are forwarded to :meth:`Solver.solve` for every
    batch. With ``solver_options={"method": "fused_dopri5"}`` (the fused
    serving fast path) the effective tolerance defaults to
    ``atol = rtol = 5e-8``, which keeps the state within 1e-5 of host
    DOP853(1e-12) on the 3-transmon dim-27 serving config (the engine's bare
    1e-6 default does not). Pass ``atol``/``rtol`` inside
    ``solver_options`` to trade accuracy for throughput.
    """

    def __init__(self, solver: Solver, target=None, **options):
        self.name = "DynamicsBackend"
        self.backend_version = "0.1"

        self._dressed_evals = None
        self._dressed_states = None
        self._dressed_states_adjoint = None

        self._options = self._default_options()

        if "subsystem_dims" not in options:
            options["subsystem_dims"] = [solver.model.dim]
        self.set_options(solver=solver, **options)

        if self.options.meas_map is None:
            self.set_options(
                meas_map=[[idx] for idx in range(len(self.options.subsystem_dims))]
            )

        self.dt = solver._dt
        self.num_qubits = len(self.options.subsystem_dims)
        self._target = self._build_target(target)

    def _build_target(self, target):
        """Resolve the transpilation target (reference
        ``dynamics_backend.py:197-221``): copy a provided target, else build
        one — a real ``qiskit.transpiler.Target`` with default measure
        calibrations when qiskit is importable, a native stand-in otherwise.
        Either way ``dt``/``num_qubits`` are stamped from the solver/options."""
        if target is None:
            try:
                from qiskit.transpiler import Target

                target = Target()
            except ImportError:
                target = SimpleNamespace(dt=None, num_qubits=None)
        else:
            # copy so backend-side dt/num_qubits stamps don't mutate the input
            target = copy.copy(target)
        # the reference adds default measure calibrations to user-provided
        # targets too (dynamics_backend.py:202-215); the helper no-ops on
        # targets without the qiskit Target API (native stand-ins)
        self._add_default_measure_instructions(target)
        # stamp independently: a read-only attribute on one must not skip
        # the other (e.g. frozen/Rust-backed Target variants)
        try:
            target.dt = self.dt
        except AttributeError:
            pass
        try:
            target.num_qubits = self.num_qubits
        except AttributeError:
            pass
        return target

    def _add_default_measure_instructions(self, target):
        """Register a default measure calibration (1-sample acquire) for
        each subsystem on a qiskit ``Target`` (reference
        ``dynamics_backend.py:203-217``)."""
        try:
            from qiskit import pulse as qiskit_pulse
            from qiskit.circuit.library import Measure
            from qiskit.transpiler import InstructionProperties

            measure_properties = {}
            instruction_schedule_map = target.instruction_schedule_map()
            for qubit in range(len(self.options.subsystem_dims)):
                if not instruction_schedule_map.has(instruction="measure", qubits=qubit):
                    with qiskit_pulse.build() as meas_sched:
                        qiskit_pulse.acquire(
                            duration=1,
                            qubit_or_channel=qubit,
                            register=qiskit_pulse.MemorySlot(qubit),
                        )
                    measure_properties[(qubit,)] = InstructionProperties(
                        calibration=meas_sched
                    )
            if measure_properties:
                target.add_instruction(Measure(), measure_properties)
        except Exception:  # qiskit API drift must not break construction
            pass

    @property
    def target(self):
        """The transpilation target (a ``qiskit.transpiler.Target`` when
        qiskit is installed; reference ``dynamics_backend.py:527-528``)."""
        return self._target

    @property
    def max_circuits(self):
        """No limit on batch size (reference ``dynamics_backend.py:522-524``)."""
        return None

    def configuration(self):
        """The ``configuration`` option (reference ``dynamics_backend.py:585-587``)."""
        return self.options.configuration

    def defaults(self):
        """The ``defaults`` option (reference ``dynamics_backend.py:589-591``)."""
        return self.options.defaults

    @staticmethod
    def _default_options() -> _Options:
        return _Options(
            shots=1024,
            solver=None,
            solver_options={},
            subsystem_dims=None,
            meas_map=None,
            control_channel_map=None,
            normalize_states=True,
            initial_state="ground_state",
            meas_level=2,
            meas_return="avg",
            iq_centers=None,
            iq_width=0.2,
            max_outcome_level=1,
            memory=True,
            seed_simulator=None,
            experiment_result_function=None,  # resolved to default at use
            configuration=None,
            defaults=None,
        )

    @property
    def options(self) -> _Options:
        """Backend options."""
        return self._options

    def set_options(self, **fields):
        """Set and validate options."""
        validate_subsystem_dims = False
        validate_iq_centers = False

        for key, value in fields.items():
            if not hasattr(self._options, key):
                raise AttributeError(f"Invalid option {key}")

            if key == "initial_state":
                if value != "ground_state" and not isinstance(
                    value, (Statevector, DensityMatrix)
                ):
                    raise DynamicsError(
                        'initial_state must be either "ground_state", or a Statevector or '
                        "DensityMatrix instance."
                    )
            elif key == "meas_level" and value not in [1, 2]:
                raise DynamicsError("Only meas_level 1 and 2 are supported by DynamicsBackend.")
            elif key == "meas_return" and value not in ["single", "avg"]:
                raise DynamicsError("meas_return must be either 'single' or 'avg'.")
            elif key == "max_outcome_level":
                if value is not None and (not isinstance(value, int) or value <= 0):
                    raise DynamicsError("max_outcome_level must be a positive integer or None.")
            elif key == "experiment_result_function" and value is not None and not callable(value):
                raise DynamicsError("experiment_result_function must be callable.")
            elif key == "iq_width" and (not isinstance(value, float) or value <= 0):
                raise DynamicsError("iq_width must be a positive float.")
            elif key == "iq_centers":
                if value is not None and not all(
                    isinstance(level, (list, tuple)) and len(level) == 2
                    for sub in value
                    for level in sub
                ):
                    raise DynamicsError(
                        "The iq_centers option must be either None or of type "
                        "List[List[List[float, float]]]."
                    )
                validate_iq_centers = True
            elif key == "subsystem_dims":
                validate_subsystem_dims = True
                validate_iq_centers = True
            elif key == "solver":
                validate_subsystem_dims = True
            elif key == "control_channel_map" and value is not None:
                if not isinstance(value, dict):
                    raise DynamicsError(
                        "The control_channel_map option must either be None or a dictionary."
                    )
                if not all(isinstance(x, int) for x in value.values()):
                    raise DynamicsError("The control_channel_map values must be of type int.")

            if key == "solver":
                self._set_solver(value)
            else:
                self._options.update_options(**{key: value})

        if (
            validate_subsystem_dims
            and np.prod(self._options.subsystem_dims) != self._options.solver.model.dim
        ):
            raise DynamicsError(
                "DynamicsBackend options subsystem_dims and solver.model.dim are inconsistent."
            )

        if validate_iq_centers and self._options.iq_centers is not None:
            if [len(sub) for sub in self._options.iq_centers] != list(
                self._options.subsystem_dims
            ):
                raise DynamicsError(
                    "iq_centers option is not consistent with subsystem_dims."
                )

    def _set_solver(self, solver: Solver):
        """Set the solver and compute dressed states of the lab-frame static H."""
        if solver._dt is None:
            raise DynamicsError(
                "Solver passed to DynamicsBackend is not configured for Pulse simulation."
            )
        self._options.update_options(solver=solver)
        static_hamiltonian = _get_lab_frame_static_hamiltonian(solver.model)
        dressed_evals, dressed_states = _get_dressed_state_decomposition(static_hamiltonian)
        self._dressed_evals = dressed_evals
        self._dressed_states = dressed_states
        self._dressed_states_adjoint = dressed_states.conj().T

    # ------------------------------------------------------------------ #
    # simulation entry points
    # ------------------------------------------------------------------ #

    def _resolve_y0(self, y0):
        if y0 is None:
            y0 = self.options.initial_state
        if isinstance(y0, str) and y0 == "ground_state":
            y0 = Statevector(self._dressed_states[:, 0], dims=tuple(self.options.subsystem_dims))
        return y0

    def solve(
        self,
        solve_input,
        t_span=None,
        y0=None,
        convert_results: bool = True,
        validate: bool = True,
    ) -> Union[OdeResult, List[OdeResult]]:
        """Simulate schedules and return raw ``OdeResult`` objects."""
        if validate:
            _validate_run_input(solve_input)
        schedules, _ = _to_schedule_list(solve_input, backend=self)
        y0 = self._resolve_y0(y0)
        if t_span is None:
            t_span = [[0, sched.duration * self.dt] for sched in schedules]
        return self.options.solver.solve(
            t_span=t_span,
            y0=y0,
            signals=schedules,
            convert_results=convert_results,
            **self.options.solver_options,
        )

    def run(self, run_input, validate: bool = True, **options) -> DynamicsJob:
        """Run simulations and return a (synchronously executed) job."""
        if validate:
            _validate_run_input(run_input)

        if options:
            backend = copy.deepcopy(self)
            backend.set_options(**options)
        else:
            backend = self

        schedules, num_memory_slots_list = _to_schedule_list(run_input, backend=backend)
        (
            t_span,
            measurement_subsystems_list,
            memory_slot_indices_list,
        ) = _get_acquire_instruction_timings(
            schedules, backend.options.subsystem_dims, backend.options.solver._dt
        )

        job = DynamicsJob(
            backend=backend,
            job_id=str(uuid.uuid4()),
            fn=backend._run,
            fn_kwargs={
                "t_span": t_span,
                "schedules": schedules,
                "measurement_subsystems_list": measurement_subsystems_list,
                "memory_slot_indices_list": memory_slot_indices_list,
                "num_memory_slots_list": num_memory_slots_list,
            },
        )
        job.submit()
        return job

    def _run(
        self,
        job_id,
        t_span,
        schedules,
        measurement_subsystems_list,
        memory_slot_indices_list,
        num_memory_slots_list,
    ) -> Result:
        """Simulate all schedules and build the Result."""
        y0 = self._resolve_y0(None)
        solver_results = self.options.solver.solve(
            t_span=t_span, y0=y0, signals=schedules, **self.options.solver_options
        )
        if not isinstance(solver_results, list):
            solver_results = [solver_results]

        result_function = (
            self.options.experiment_result_function or default_experiment_result_function
        )
        if result_function is default_experiment_result_function:
            # ONE device->host transfer for all experiments: per-experiment
            # transfers inside the result function are latency-bound and
            # would dominate `run` end to end. After prefetch, the
            # result-function transfers are no-ops. Custom result functions
            # keep the untouched results (their contract may read more than
            # y[-1]).
            solver_results = _prefetch_final_states(solver_results)
        rng = np.random.default_rng(self.options.seed_simulator)
        experiment_results = []
        for (
            schedule,
            solver_result,
            measurement_subsystems,
            memory_slot_indices,
            num_memory_slots,
        ) in zip(
            schedules,
            solver_results,
            measurement_subsystems_list,
            memory_slot_indices_list,
            num_memory_slots_list,
        ):
            experiment_results.append(
                result_function(
                    schedule.name,
                    solver_result,
                    measurement_subsystems,
                    memory_slot_indices,
                    num_memory_slots,
                    self,
                    seed=int(rng.integers(low=0, high=9223372036854775807)),
                    metadata=getattr(schedule, "metadata", None),
                )
            )

        return Result(
            backend_name=self.name,
            backend_version=self.backend_version,
            job_id=job_id,
            success=True,
            results=experiment_results,
            date=datetime.datetime.now().isoformat(),
        )

    @property
    def meas_map(self) -> List[List[int]]:
        """Measurement map."""
        return self.options.meas_map

    # --- channel accessors (reference dynamics_backend.py:530-590) -------- #

    def _get_qubit_channel(self, qubit: int, cls, method_name: str):
        if qubit < len(self.options.subsystem_dims):
            return cls(qubit)
        raise DynamicsError(
            f"{method_name} requested for qubit {qubit}, which is out of bounds."
        )

    def drive_channel(self, qubit: int):
        """Drive channel for a qubit."""
        from ..pulse import DriveChannel

        return self._get_qubit_channel(qubit, DriveChannel, "drive_channel")

    def measure_channel(self, qubit: int):
        """Measure channel for a qubit."""
        from ..pulse import MeasureChannel

        return self._get_qubit_channel(qubit, MeasureChannel, "measure_channel")

    def acquire_channel(self, qubit: int):
        """Acquire channel for a qubit."""
        from ..pulse import AcquireChannel

        return self._get_qubit_channel(qubit, AcquireChannel, "acquire_channel")

    def control_channel(self, qubits):
        """Control channel(s) looked up via the ``control_channel_map`` option."""
        from ..pulse import ControlChannel

        if self.options.control_channel_map is None:
            raise NotImplementedError
        if not isinstance(qubits, list):
            qubits = [qubits]
        channels = []
        for label in qubits:
            if label not in self.options.control_channel_map:
                raise DynamicsError(f"Key {label} not in control_channel_map.")
            channels.append(ControlChannel(self.options.control_channel_map[label]))
        return channels

    @classmethod
    def from_config(
        cls,
        hamiltonian_dict: dict,
        dt: float,
        channel_carrier_freqs: Dict[str, float],
        subsystem_list: Optional[List[int]] = None,
        rotating_frame: Union[str, None, np.ndarray] = "auto",
        array_library: Optional[str] = None,
        vectorized: bool = False,
        rwa_cutoff_freq: Optional[float] = None,
        **options,
    ) -> "DynamicsBackend":
        """Build a backend from a pulse-backend Hamiltonian dictionary.

        Native equivalent of the reference's ``from_backend``
        (``dynamics_backend.py:593-802``) taking the configuration data
        directly instead of a qiskit backend object.

        Args:
            hamiltonian_dict: Hamiltonian dict (see
                :func:`parse_backend_hamiltonian_dict`).
            dt: Sample width in seconds (or model time units).
            channel_carrier_freqs: carrier frequency for every channel label
                appearing in the parsed Hamiltonian (e.g. ``{"d0": 5.1e9}``).
            subsystem_list: subsystems to keep.
            rotating_frame: ``"auto"`` selects the diagonal of the static
                Hamiltonian (dense) or the full static Hamiltonian; also
                accepts an explicit frame operator or ``None``.
            array_library: array library for the model.
            vectorized: whether to vectorize a Lindblad model.
            rwa_cutoff_freq: optional RWA cutoff.
            options: backend options.
        """
        (
            static_hamiltonian,
            hamiltonian_operators,
            channels,
            subsystem_dims_dict,
        ) = parse_backend_hamiltonian_dict(hamiltonian_dict, subsystem_list)

        missing = [ch for ch in channels if ch not in channel_carrier_freqs]
        if missing:
            raise DynamicsError(f"channel_carrier_freqs missing carriers for: {missing}")

        if isinstance(rotating_frame, str) and rotating_frame == "auto":
            if array_library is not None and "sparse" in array_library:
                rotating_frame = np.diag(np.diag(static_hamiltonian))
            else:
                rotating_frame = static_hamiltonian

        solver = Solver(
            static_hamiltonian=static_hamiltonian,
            hamiltonian_operators=hamiltonian_operators,
            hamiltonian_channels=channels,
            channel_carrier_freqs={ch: channel_carrier_freqs[ch] for ch in channels},
            dt=dt,
            rotating_frame=rotating_frame,
            array_library=array_library,
            vectorized=vectorized,
            rwa_cutoff_freq=rwa_cutoff_freq,
        )
        return cls(
            solver=solver, subsystem_dims=list(subsystem_dims_dict.values()), **options
        )

    @classmethod
    def from_backend(cls, backend, subsystem_list=None, **kwargs) -> "DynamicsBackend":
        """Build from a qiskit backend instance (BackendV1 or BackendV2 shaped).

        Channel carrier frequencies are resolved with the same precedence as
        the reference (``dynamics_backend.py:593-802, 1047-1135``): drive
        frequencies from ``backend.target.qubit_properties`` when present,
        falling back to ``defaults().qubit_freq_est``; measure frequencies
        from ``defaults().meas_freq_est``; control-channel LOs composed from
        ``configuration().u_channel_lo``. Only the channels actually
        appearing in the (``subsystem_list``-restricted) parsed Hamiltonian
        need frequencies.
        """
        config = _call_if_exists(backend, "configuration")
        if config is None or getattr(config, "hamiltonian", None) is None:
            raise DynamicsError(
                "DynamicsBackend.from_backend requires a backend exposing a pulse "
                "configuration with a Hamiltonian dict; alternatively use from_config."
            )
        target = getattr(backend, "target", None)
        defaults = _call_if_exists(backend, "defaults")

        dt = getattr(config, "dt", None)
        if dt is None and target is not None:
            dt = getattr(target, "dt", None)
        if dt is None:
            raise DynamicsError("Backend does not expose a sample width dt.")

        # parse first so only the channels actually present (after the
        # subsystem restriction) need frequency resolution
        _, _, channels, _ = parse_backend_hamiltonian_dict(
            config.hamiltonian, subsystem_list
        )
        channel_carrier_freqs = _resolve_backend_channel_freqs(
            target=target, config=config, defaults=defaults, channels=channels
        )
        return cls.from_config(
            hamiltonian_dict=config.hamiltonian,
            dt=dt,
            channel_carrier_freqs=channel_carrier_freqs,
            subsystem_list=subsystem_list,
            **kwargs,
        )


def _call_if_exists(obj, name: str):
    """Call ``obj.name()`` if present, tolerating backends that raise
    AttributeError/NotImplementedError for unsupported legacy accessors."""
    fn = getattr(obj, name, None)
    if not callable(fn):
        return None
    try:
        return fn()
    except (AttributeError, NotImplementedError):
        return None


def _resolve_backend_channel_freqs(target, config, defaults, channels) -> Dict[str, float]:
    """Resolve carrier frequencies for ``channels`` from backend metadata.

    Mirrors the reference's precedence rules
    (``/root/reference/qiskit_dynamics/backend/dynamics_backend.py:1047-1135``):
    drive (``d<j>``) from ``target.qubit_properties`` else
    ``defaults.qubit_freq_est``; measure (``m<j>``) from
    ``defaults.meas_freq_est``; control (``u<j>``) as the LO combination
    ``sum_q drive[q] * scale`` over ``config.u_channel_lo[j]``.
    """
    drive_chs = [ch for ch in channels if ch[0] == "d"]
    meas_chs = [ch for ch in channels if ch[0] == "m"]
    u_chs = [ch for ch in channels if ch[0] == "u"]
    unknown = set(channels) - set(drive_chs) - set(meas_chs) - set(u_chs)
    if unknown:
        raise DynamicsError(f"Unrecognized channel type(s) requested: {sorted(unknown)}")

    drive_freqs = []
    if drive_chs or u_chs:
        if target is not None and getattr(target, "qubit_properties", None) is not None:
            drive_freqs = [q.frequency for q in target.qubit_properties]
        elif defaults is not None and getattr(defaults, "qubit_freq_est", None) is not None:
            drive_freqs = list(defaults.qubit_freq_est)
        else:
            raise DynamicsError(
                "DriveChannels in model but frequencies not available in target "
                "or defaults."
            )

    freqs: Dict[str, float] = {}
    for ch in drive_chs:
        idx = int(ch[1:])
        if idx >= len(drive_freqs):
            raise DynamicsError(f"DriveChannel index {idx} is out of bounds.")
        freqs[ch] = drive_freqs[idx]

    if meas_chs:
        meas_freqs = getattr(defaults, "meas_freq_est", None) if defaults else None
        if meas_freqs is None:
            raise DynamicsError(
                "MeasureChannels in model but defaults does not have meas_freq_est."
            )
        for ch in meas_chs:
            idx = int(ch[1:])
            if idx >= len(meas_freqs):
                raise DynamicsError(f"MeasureChannel index {idx} is out of bounds.")
            freqs[ch] = meas_freqs[idx]

    u_channel_lo = getattr(config, "u_channel_lo", []) or []
    for ch in u_chs:
        idx = int(ch[1:])
        if idx >= len(u_channel_lo):
            raise DynamicsError(f"ControlChannel index {idx} is out of bounds.")
        freq = 0.0
        for lo in u_channel_lo[idx]:
            if lo.q >= len(drive_freqs):
                raise DynamicsError(
                    f"u_channel_lo[{idx}] references qubit {lo.q} with no drive "
                    "frequency."
                )
            freq += drive_freqs[lo.q] * np.real(lo.scale)
        freqs[ch] = freq

    missing = [ch for ch in channels if ch not in freqs]
    if missing:
        raise DynamicsError(f"No carrier frequency found for channel(s) {missing}.")
    return freqs


def _prefetch_final_states(solver_results: list) -> list:
    """Batch the device->host transfer of all experiments' final states.

    Groups the final states (and final times) by shape, stacks each group on
    device, and moves it in ONE complex-safe transfer (``utils.to_host``),
    then rebuilds lightweight :class:`OdeResult` views holding host arrays.
    Only ``y[-1]``/``t[-1]`` are materialized — exactly what the default
    measurement pipeline consumes; all other result fields pass through.
    """
    import jax
    import jax.numpy as jnp

    from ..utils.jit_tools import to_host

    datas, wrappers, t_lasts = [], [], []
    for res in solver_results:
        yf = res.y[-1]
        if hasattr(yf, "data") and hasattr(yf, "dims"):
            wrappers.append((type(yf), yf.dims()))
            datas.append(yf.data)
        else:
            wrappers.append((None, None))
            datas.append(yf)
        t_lasts.append(res.t[-1])

    def batch_transfer(values):
        by_shape = {}
        for i, v in enumerate(values):
            if isinstance(v, jax.Array):
                by_shape.setdefault((v.shape, str(v.dtype)), []).append(i)
        out = list(values)
        for idxs in by_shape.values():
            stacked = to_host(jnp.stack([values[i] for i in idxs]))
            for j, i in enumerate(idxs):
                out[i] = stacked[j]
        return out

    datas = batch_transfer(datas)
    t_lasts = batch_transfer(t_lasts)

    prefetched = []
    for res, (cls, dims), data, t_last in zip(solver_results, wrappers, datas, t_lasts):
        yf = cls(data, dims=dims) if cls is not None else data
        new = OdeResult(res)
        new["y"] = [yf]
        new["t"] = [to_host(t_last)]
        prefetched.append(new)
    return prefetched


def default_experiment_result_function(
    experiment_name: str,
    solver_result: OdeResult,
    measurement_subsystems: List[int],
    memory_slot_indices: List[int],
    num_memory_slots: Union[None, int],
    backend: DynamicsBackend,
    seed: Optional[int] = None,
    metadata: Optional[Dict] = None,
) -> ExperimentResult:
    """Default measurement pipeline: frame-out -> dressed basis -> normalize ->
    probabilities -> counts (meas_level 2) or Gaussian IQ clouds (meas_level 1)."""
    from ..utils.jit_tools import to_host

    yf = solver_result.y[-1]
    tf = to_host(solver_result.t[-1])
    # jax solver methods return device arrays; the measurement pipeline is
    # host-side numpy — bring the final state to the host first
    if hasattr(yf, "data") and hasattr(yf, "dims"):
        yf = type(yf)(to_host(yf.data), dims=yf.dims())
    else:
        yf = to_host(yf)

    if isinstance(yf, Statevector) or type(yf).__name__ == "Statevector":
        arr = np.asarray(
            backend.options.solver.model.rotating_frame.state_out_of_frame(
                t=tf, y=np.asarray(yf)
            )
        )
        arr = backend._dressed_states_adjoint @ arr
        if backend.options.normalize_states:
            arr = arr / np.linalg.norm(arr)
        yf = Statevector(arr, dims=tuple(backend.options.subsystem_dims))
    elif isinstance(yf, DensityMatrix) or type(yf).__name__ == "DensityMatrix":
        arr = np.asarray(
            backend.options.solver.model.rotating_frame.operator_out_of_frame(
                t=tf, operator=np.asarray(yf)
            )
        )
        arr = backend._dressed_states_adjoint @ arr @ backend._dressed_states
        if backend.options.normalize_states:
            arr = arr / np.diag(arr).sum()
        yf = DensityMatrix(arr, dims=tuple(backend.options.subsystem_dims))
    else:
        raise DynamicsError(
            f"State type {type(yf)} not supported by default_experiment_result_function."
        )

    header = {"name": experiment_name, "metadata": metadata}

    if backend.options.meas_level == 2:
        memory_slot_probabilities = _get_memory_slot_probabilities(
            probability_dict=_probabilities_dict(
                yf.probabilities(), yf.dims(), qargs=measurement_subsystems
            ),
            memory_slot_indices=memory_slot_indices,
            num_memory_slots=num_memory_slots,
            max_outcome_value=backend.options.max_outcome_level,
        )
        from .backend_utils import _sample_outcomes

        memory_samples, counts = _sample_outcomes(
            memory_slot_probabilities,
            shots=backend.options.shots,
            normalize_probabilities=backend.options.normalize_states,
            seed=seed,
            with_memory=bool(backend.options.memory),
        )
        exp_data = ExperimentResultData(counts=counts, memory=memory_samples)
        return ExperimentResult(
            shots=backend.options.shots,
            success=True,
            data=exp_data,
            meas_level=2,
            seed=seed,
            header=header,
        )

    # meas_level == 1
    iq_centers = backend.options.iq_centers
    if iq_centers is None:
        from .backend_utils import _default_iq_centers

        iq_centers = _default_iq_centers(backend.options.subsystem_dims)

    measurement_data = _get_iq_data(
        yf,
        measurement_subsystems=measurement_subsystems,
        iq_centers=iq_centers,
        iq_width=backend.options.iq_width,
        shots=backend.options.shots,
        memory_slot_indices=memory_slot_indices,
        num_memory_slots=num_memory_slots,
        seed=seed,
    )
    if backend.options.meas_return == "avg":
        measurement_data = np.average(measurement_data, axis=0)

    return ExperimentResult(
        shots=backend.options.shots,
        success=True,
        data=ExperimentResultData(memory=measurement_data),
        meas_level=1,
        seed=seed,
        header=header,
    )
