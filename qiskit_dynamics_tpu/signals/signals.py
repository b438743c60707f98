"""Time-dependent model coefficients ("signals").

TPU-first re-design of the reference signal layer
(``/root/reference/qiskit_dynamics/signals/signals.py``). Behavioral contract
is preserved:

- ``Signal`` represents ``Re[f(t) exp(i(2 pi nu t + phi))]`` with callable or
  constant envelope ``f``.
- ``DiscreteSignal`` is piecewise constant: ``f(t) = samples[floor((t-t0)/dt)]``
  inside the support and 0 outside.
- ``SignalSum`` / ``DiscreteSignalSum`` are sums with array-valued
  ``carrier_freq`` / ``phase`` and vectorized ``envelope(t) -> (..., k)``.
- ``SignalList`` evaluates independent signal components simultaneously.
- Multiplication expands into two sideband terms with carriers ``nu1 +/- nu2``.

TPU-first differences from the reference:

- All numeric state is ``jax.numpy``; every class is a registered pytree, so
  signals can cross ``jit`` boundaries as arguments (the reference instead
  mutates ``model.signals`` host-side and rebuilds signals inside traces).
- ``DiscreteSignalSum`` evaluation is a single 2-d gather + one complex-exp
  fused by XLA — no per-component Python loop on the hot path.
"""
from __future__ import annotations

import itertools
import operator
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from ..unified import unp
from jax.tree_util import register_pytree_node

from ..dtypes import ArrayLike
from ..exceptions import DynamicsError

__all__ = [
    "Signal",
    "DiscreteSignal",
    "SignalCollection",
    "SignalSum",
    "DiscreteSignalSum",
    "SignalList",
    "signal_add",
    "signal_multiply",
    "to_SignalSum",
]

_TWO_PI = 2 * np.pi


def _is_tracer(x) -> bool:
    return isinstance(x, jax.core.Tracer)


class Signal:
    r"""A function of the form ``Re[f(t) exp(i(2 pi nu t + phi))]``.

    ``envelope`` may be a vectorized callable ``f(t)`` or a constant value; the
    carrier frequency ``nu`` and phase ``phi`` are real (arrays for subclasses
    representing sums).
    """

    def __init__(
        self,
        envelope: Union[Callable, ArrayLike],
        carrier_freq: ArrayLike = 0.0,
        phase: ArrayLike = 0.0,
        name: Optional[str] = None,
    ):
        self._name = name
        self._is_constant = False

        if not callable(envelope):
            const = unp.asarray(envelope)
            if not _is_tracer(carrier_freq) and np.all(np.asarray(carrier_freq) == 0.0):
                self._is_constant = True
            envelope = _ConstantEnvelope(const)

        self._envelope = envelope
        self.carrier_freq = carrier_freq
        self.phase = phase

    # --- basic properties -------------------------------------------------
    @property
    def name(self) -> Optional[str]:
        """Name of the signal."""
        return self._name

    @property
    def is_constant(self) -> bool:
        """Whether this signal is a constant (constant envelope, zero carrier)."""
        return self._is_constant

    @property
    def carrier_freq(self):
        """Carrier frequency (array-valued in subclasses)."""
        return self._carrier_freq

    @carrier_freq.setter
    def carrier_freq(self, carrier_freq):
        self._carrier_freq = unp.asarray(carrier_freq)

    @property
    def phase(self):
        """Carrier phase (array-valued in subclasses)."""
        return self._phase

    @phase.setter
    def phase(self, phase):
        self._phase = unp.asarray(phase)

    # --- evaluation ---------------------------------------------------------
    def envelope(self, t: ArrayLike):
        """Vectorized envelope evaluation."""
        return self._envelope(t)

    def complex_value(self, t: ArrayLike):
        """Vectorized evaluation of ``f(t) exp(i(2 pi nu t + phi))``."""
        t = unp.asarray(t)
        arg = 1j * (_TWO_PI * self._carrier_freq * t + self._phase)
        return self.envelope(t) * unp.exp(arg)

    def __call__(self, t: ArrayLike):
        """Vectorized evaluation of the real signal."""
        return unp.real(self.complex_value(t))

    # --- algebra --------------------------------------------------------------
    def __add__(self, other) -> "SignalSum":
        return signal_add(self, other)

    def __radd__(self, other) -> "SignalSum":
        return self.__add__(other)

    def __mul__(self, other) -> "SignalSum":
        return signal_multiply(self, other)

    def __rmul__(self, other) -> "SignalSum":
        return self.__mul__(other)

    def __neg__(self) -> "SignalSum":
        return -1.0 * self

    def __sub__(self, other) -> "SignalSum":
        return self + (-other)

    def __rsub__(self, other) -> "SignalSum":
        return other + (-self)

    def conjugate(self) -> "Signal":
        """Signal whose complex value is the conjugate of this one."""
        env = self._envelope

        def conj_env(t):
            return unp.conjugate(env(t))

        return Signal(conj_env, -self.carrier_freq, -self.phase)

    def __str__(self):
        if self.name is not None:
            return str(self.name)
        if self.is_constant:
            return f"Constant({self(0.0)})"
        return f"Signal(carrier_freq={self.carrier_freq}, phase={self.phase})"

    def __repr__(self):
        return self.__str__()

    # --- plotting ----------------------------------------------------------
    def draw(self, t0, tf, n, function="signal", axis=None, title=None):
        """Plot signal / envelope / complex value over ``[t0, tf]``."""
        import matplotlib.pyplot as plt  # deferred: optional dependency

        plotter = axis if axis is not None else plt
        t_vals = np.linspace(t0, tf, n)
        if function == "signal":
            y_vals, complex_data = self(t_vals), False
            title = title or f"Value of {self}"
        elif function == "envelope":
            y_vals, complex_data = self.envelope(t_vals), True
            title = title or f"Envelope of {self}"
        elif function == "complex_value":
            y_vals, complex_data = self.complex_value(t_vals), True
            title = title or f"Complex value of {self}"
        else:
            raise DynamicsError(f"Unknown draw function {function}.")

        if axis is None:
            plt.title(title)
        else:
            axis.set_title(title)
        if complex_data:
            plotter.plot(t_vals, np.real(y_vals), label="Real")
            plotter.plot(t_vals, np.imag(y_vals), label="Imag")
            plotter.legend()
        else:
            plotter.plot(t_vals, np.asarray(y_vals))

    # --- pytree protocol -----------------------------------------------------
    def tree_flatten(self):
        return (self._carrier_freq, self._phase), (self._envelope, self._name, self._is_constant)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        obj._envelope, obj._name, obj._is_constant = aux
        obj._carrier_freq, obj._phase = leaves
        return obj


class _ConstantEnvelope:
    """Constant envelope callable; hashable so it can live in pytree aux data."""

    def __init__(self, value):
        self.value = unp.asarray(value)

    def __call__(self, t):
        return self.value * unp.ones_like(unp.asarray(t))

    def __hash__(self):
        return hash(float(np.real(np.asarray(self.value)))) if self.value.ndim == 0 else id(self)

    def __eq__(self, other):
        if not isinstance(other, _ConstantEnvelope):
            return NotImplemented
        try:
            return bool(np.all(np.asarray(self.value) == np.asarray(other.value)))
        except Exception:  # tracers
            return self is other


class DiscreteSignal(Signal):
    r"""Piecewise-constant signal defined by samples on a uniform grid.

    ``f(t) = samples[floor((t - start_time)/dt)]`` inside the support
    ``[start_time, start_time + dt * len(samples))`` and 0 outside. Envelope
    lookup is one clipped gather (reference: zero-padded sample array with a
    clipped floor index, ``signals.py:295-313``).
    """

    def __init__(
        self,
        dt: float,
        samples: ArrayLike,
        start_time: float = 0.0,
        carrier_freq: ArrayLike = 0.0,
        phase: ArrayLike = 0.0,
        name: Optional[str] = None,
    ):
        self._dt = dt
        self._start_time = start_time
        samples = unp.asarray(samples)
        if samples.shape[0] == 0:
            pad = unp.zeros((1,) + samples.shape[1:], dtype=samples.dtype)
        else:
            pad = unp.zeros_like(samples[:1])
        self._padded_samples = unp.concatenate([samples, pad], axis=0)

        Signal.__init__(
            self, envelope=self._envelope_fn, carrier_freq=carrier_freq, phase=phase, name=name
        )

    def _envelope_fn(self, t):
        t = unp.asarray(t)
        n = self._padded_samples.shape[0] - 1
        # multiply by an explicit reciprocal rather than divide: XLA rewrites
        # division-by-constant into reciprocal multiplication under jit,
        # which rounds differently from numpy's true division at exact cell
        # boundaries (e.g. 0.3/0.1 = 2.99..6 but 0.3*10.0 = 3.00..4) — the
        # explicit multiply makes eager and jitted lookups bit-identical
        inv_dt = 1.0 / self._dt
        idx = unp.clip(
            unp.floor((t - self._start_time) * inv_dt).astype(np.int32), -1, n
        )
        # idx in [-1, n]; both -1 and n hit the zero pad via wrap mode.
        return unp.take(self._padded_samples, idx, axis=0, mode="wrap")

    @classmethod
    def from_Signal(
        cls,
        signal: Signal,
        dt: float,
        n_samples: int,
        start_time: float = 0.0,
        sample_carrier: bool = False,
    ) -> "DiscreteSignal":
        """Sample a ``Signal`` at interval midpoints.

        If ``sample_carrier``, the carrier is folded into the samples and the
        result has zero carrier frequency.
        """
        times = start_time + (np.arange(n_samples) + 0.5) * dt
        if sample_carrier:
            freq = 0.0
            samples = signal(times)
        else:
            freq = signal.carrier_freq
            samples = signal.envelope(times)
        return cls(
            dt, samples, start_time=start_time, carrier_freq=freq, phase=signal.phase,
            name=signal.name,
        )

    @property
    def duration(self) -> int:
        """Number of samples."""
        return self._padded_samples.shape[0] - 1

    @property
    def dt(self) -> float:
        """Sample duration."""
        return self._dt

    @property
    def samples(self):
        """The sample array."""
        return self._padded_samples[:-1]

    @property
    def start_time(self) -> float:
        """Support start time."""
        return self._start_time

    def conjugate(self):
        return self.__class__(
            dt=self._dt,
            samples=unp.conjugate(self.samples),
            start_time=self._start_time,
            carrier_freq=-self.carrier_freq,
            phase=-self.phase,
        )

    def add_samples(self, start_sample: int, samples):
        """Append samples starting at index ``start_sample``, zero-filling any gap."""
        samples = unp.asarray(samples)
        if samples.shape[0] < 1:
            return
        cur = self.samples
        if start_sample < cur.shape[0]:
            raise DynamicsError("Samples can only be added after the last sample.")
        if cur.shape[0] < start_sample:
            gap = unp.zeros((start_sample - cur.shape[0],) + cur.shape[1:], dtype=cur.dtype)
            cur = unp.concatenate([cur, gap], axis=0)
        new = unp.concatenate([cur, samples], axis=0)
        pad = unp.zeros_like(new[:1])
        self._padded_samples = unp.concatenate([new, pad], axis=0)

    def __str__(self):
        if self.name is not None:
            return str(self.name)
        return (
            f"DiscreteSignal(dt={self.dt}, carrier_freq={self.carrier_freq}, phase={self.phase})"
        )

    # --- pytree protocol --------------------------------------------------
    def tree_flatten(self):
        return (self._padded_samples, self._carrier_freq, self._phase), (
            self._dt,
            self._start_time,
            self._name,
        )

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        obj._dt, obj._start_time, obj._name = aux
        obj._padded_samples, obj._carrier_freq, obj._phase = leaves
        obj._is_constant = False
        obj._envelope = obj._envelope_fn
        return obj


class SignalCollection:
    """Base class for list-like collections of signals."""

    def __init__(self, signal_list: List[Signal]):
        self._is_constant = False
        self._components = list(signal_list)

    @property
    def components(self) -> List[Signal]:
        """The component signals."""
        return self._components

    def __len__(self):
        return len(self._components)

    def __getitem__(self, idx):
        if not isinstance(idx, slice) and unp.asarray(idx).ndim > 0:
            idx = list(np.asarray(idx))
        if isinstance(idx, list):
            sub = [self._components[i] for i in idx]
            return self.__class__(sub)
        sub = operator.itemgetter(idx)(self._components)
        if isinstance(sub, list):
            return self.__class__(sub)
        return sub

    def __iter__(self):
        return iter(self._components)

    def conjugate(self):
        """Conjugate of every component."""
        return self.__class__([sig.conjugate() for sig in self._components])


class SignalSum(SignalCollection, Signal):
    r"""A sum ``s_1(t) + ... + s_k(t)`` of signals.

    ``carrier_freq``/``phase`` are ``(k,)`` arrays; ``envelope(t)`` returns the
    stacked component envelopes with shape ``(..., k)``.
    """

    def __init__(self, *signals, name: Optional[str] = None):
        self._name = name
        components = []
        for sig in signals:
            if isinstance(sig, list):
                sig = SignalSum(*sig)
            if isinstance(sig, SignalSum):
                components += sig.components
            elif isinstance(sig, Signal):
                components.append(sig)
            else:
                arr = unp.asarray(sig)
                if arr.ndim == 0:
                    components.append(Signal(arr))
                else:
                    raise DynamicsError(
                        "Components of a SignalSum must be Signal instances or scalars."
                    )

        SignalCollection.__init__(self, components)
        Signal.__init__(
            self,
            envelope=self._envelope_fn,
            carrier_freq=unp.asarray([sig.carrier_freq for sig in components]),
            phase=unp.asarray([sig.phase for sig in components]),
            name=name,
        )

    def _envelope_fn(self, t):
        return unp.moveaxis(unp.asarray([sig.envelope(t) for sig in self._components]), 0, -1)

    def complex_value(self, t: ArrayLike):
        t = unp.asarray(t)
        arg = 1j * (_TWO_PI * unp.expand_dims(t, -1) * self._carrier_freq + self._phase)
        return unp.sum(self.envelope(t) * unp.exp(arg), axis=-1)

    def flatten(self) -> Signal:
        """Merge into a single ``Signal`` carried at the average frequency."""
        if len(self) == 0:
            return Signal(0.0)
        if len(self) == 1:
            return self._components[0]
        ave_freq = unp.sum(self.carrier_freq) / len(self)
        shifted = 1j * _TWO_PI * (self._carrier_freq - ave_freq)
        phases = 1j * self._phase
        env = self._envelope

        def merged_env(t):
            t = unp.asarray(t)
            return unp.sum(env(t) * unp.exp(unp.expand_dims(t, -1) * shifted + phases), axis=-1)

        return Signal(envelope=merged_env, carrier_freq=ave_freq, name=str(self))

    def __str__(self):
        if self.name is not None:
            return str(self.name)
        if len(self) == 0:
            return "SignalSum()"
        return " + ".join(str(sig) for sig in self._components)

    # --- pytree protocol --------------------------------------------------
    def tree_flatten(self):
        return (self._components, self._carrier_freq, self._phase), (self._name,)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        (obj._name,) = aux
        obj._components, obj._carrier_freq, obj._phase = leaves
        obj._is_constant = False
        obj._envelope = obj._envelope_fn
        return obj


class DiscreteSignalSum(DiscreteSignal, SignalSum):
    """Sum of piecewise-constant signals sharing dt/start_time/duration.

    Samples form a 2-d array (time, term); evaluation of all terms is a single
    row gather followed by one complex-exp — the batched layout used on
    every pulse-simulation hot path.
    """

    def __init__(
        self,
        dt: float,
        samples: ArrayLike,
        start_time: float = 0.0,
        carrier_freq: ArrayLike = None,
        phase: ArrayLike = None,
        name: Optional[str] = None,
    ):
        samples = unp.asarray(samples)
        if samples.ndim == 1:
            samples = samples[:, None]
        if carrier_freq is None:
            carrier_freq = unp.zeros(samples.shape[-1])
        if phase is None:
            phase = unp.zeros(samples.shape[-1])

        DiscreteSignal.__init__(
            self,
            dt=dt,
            samples=samples,
            start_time=start_time,
            carrier_freq=carrier_freq,
            phase=phase,
            name=name,
        )
        self._components = self._build_components()

    def _build_components(self):
        comps = []
        samples = self.samples
        freqs = np.asarray(self.carrier_freq) if not _is_tracer(self.carrier_freq) else None
        for k in range(samples.shape[-1]):
            comps.append(
                DiscreteSignal(
                    dt=self.dt,
                    samples=samples[:, k],
                    start_time=self.start_time,
                    carrier_freq=self.carrier_freq[k],
                    phase=self.phase[k],
                )
            )
        return comps

    @classmethod
    def from_SignalSum(
        cls,
        signal_sum: SignalSum,
        dt: float,
        n_samples: int,
        start_time: float = 0.0,
        sample_carrier: bool = False,
    ) -> "DiscreteSignalSum":
        """Sample a ``SignalSum`` at interval midpoints."""
        times = start_time + (np.arange(n_samples) + 0.5) * dt
        freq = signal_sum.carrier_freq
        if sample_carrier:
            carrier = unp.exp(
                1j * _TWO_PI * unp.expand_dims(unp.asarray(times), -1) * freq
            )
            samples = signal_sum.envelope(times) * carrier
            freq = 0.0 * freq
        else:
            samples = signal_sum.envelope(times)
        return cls(
            dt,
            samples,
            start_time=start_time,
            carrier_freq=freq,
            phase=signal_sum.phase,
            name=signal_sum.name,
        )

    def envelope(self, t):
        """All-term envelope via one gather: shape ``(..., k)``."""
        return DiscreteSignal.envelope(self, t)

    def complex_value(self, t):
        return SignalSum.complex_value(self, t)

    def __getitem__(self, idx):
        if isinstance(idx, int) and idx >= len(self):
            raise IndexError(f"index out of range for DiscreteSignalSum of length {len(self)}")
        samples = self.samples[:, idx]
        freqs = self.carrier_freq[idx]
        phases = self.phase[idx]
        if samples.ndim == 1:
            return DiscreteSignal(
                dt=self.dt, samples=samples, start_time=self.start_time,
                carrier_freq=freqs, phase=phases,
            )
        return DiscreteSignalSum(
            dt=self.dt, samples=samples, start_time=self.start_time,
            carrier_freq=freqs, phase=phases,
        )

    def __str__(self):
        if self.name is not None:
            return str(self.name)
        if len(self) == 0:
            return "DiscreteSignalSum()"
        return " + ".join(str(sig) for sig in self._components)

    def __len__(self):
        return self._padded_samples.shape[-1]

    # --- pytree protocol --------------------------------------------------
    def tree_flatten(self):
        return (self._padded_samples, self._carrier_freq, self._phase), (
            self._dt,
            self._start_time,
            self._name,
        )

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        obj._dt, obj._start_time, obj._name = aux
        obj._padded_samples, obj._carrier_freq, obj._phase = leaves
        obj._is_constant = False
        obj._envelope = obj._envelope_fn
        if any(_is_tracer(leaf) for leaf in leaves):
            obj._components = []
        else:
            obj._components = obj._build_components()
        return obj


class SignalList(SignalCollection):
    """A list of signals evaluated simultaneously: ``__call__(t) -> (..., k)``."""

    def __init__(self, signal_list: List[Signal]):
        super().__init__([to_SignalSum(sig) for sig in signal_list])

    def complex_value(self, t):
        """Stacked complex values, shape ``(..., k)``."""
        return unp.moveaxis(
            unp.asarray([sig.complex_value(t) for sig in self._components]), 0, -1
        )

    def __call__(self, t):
        return unp.moveaxis(unp.asarray([sig(t) for sig in self._components]), 0, -1)

    def flatten(self) -> "SignalList":
        """Flatten each component sum into a single signal."""
        out = []
        for sig in self._components:
            out.append(sig.flatten() if isinstance(sig, SignalSum) else sig)
        return SignalList(out)

    @property
    def drift(self):
        """Sum of the constant parts of each component."""
        drift = []
        for entry in self._components:
            if not isinstance(entry, SignalSum):
                entry = SignalSum(entry)
            val = unp.asarray(0.0)
            for term in entry:
                if term.is_constant:
                    val = val + term(0.0)
            drift.append(val)
        return unp.asarray(drift)

    # --- pytree protocol --------------------------------------------------
    def tree_flatten(self):
        return (self._components,), ()

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        obj = object.__new__(cls)
        obj._components = leaves[0]
        obj._is_constant = False
        return obj


# ---------------------------------------------------------------------------
# Signal algebra
# ---------------------------------------------------------------------------


def signal_add(sig1, sig2) -> SignalSum:
    """Add two signals, with a fast sample-append path for compatible sums."""
    try:
        sig1, sig2 = to_SignalSum(sig1), to_SignalSum(sig2)
    except DynamicsError as exc:
        raise DynamicsError("Only a number or a Signal instance can be added to a Signal.") from exc

    if isinstance(sig1, DiscreteSignalSum) and isinstance(sig2, DiscreteSignalSum):
        if (
            sig1.dt == sig2.dt
            and sig1.start_time == sig2.start_time
            and sig1.duration == sig2.duration
        ):
            return DiscreteSignalSum(
                dt=sig1.dt,
                samples=unp.concatenate([sig1.samples, sig2.samples], axis=1),
                start_time=sig1.start_time,
                carrier_freq=unp.concatenate(
                    [unp.atleast_1d(sig1.carrier_freq), unp.atleast_1d(sig2.carrier_freq)]
                ),
                phase=unp.concatenate([unp.atleast_1d(sig1.phase), unp.atleast_1d(sig2.phase)]),
            )
    return SignalSum(*(sig1.components + sig2.components))


def signal_multiply(sig1, sig2) -> SignalSum:
    r"""Multiply two signals, expanding ``Re[a]Re[b]`` into two sidebands with
    carriers ``nu1 + nu2`` and ``nu1 - nu2`` (reference formula,
    ``signals.py:874-905``). Distributes over sums.
    """
    try:
        sig1, sig2 = to_SignalSum(sig1), to_SignalSum(sig2)
    except DynamicsError as exc:
        raise DynamicsError("Only a number or a Signal instance can multiply a Signal.") from exc

    sig1, sig2 = sort_signals(sig1, sig2)

    # constant x DiscreteSignalSum: scale samples in place
    if len(sig1) == 1 and sig1[0].is_constant and isinstance(sig2, DiscreteSignalSum):
        return DiscreteSignalSum(
            dt=sig2.dt,
            samples=sig1(0.0) * sig2.samples,
            start_time=sig2.start_time,
            carrier_freq=sig2.carrier_freq,
            phase=sig2.phase,
        )

    # compatible DiscreteSignalSums: vectorized outer-product expansion
    if isinstance(sig1, DiscreteSignalSum) and isinstance(sig2, DiscreteSignalSum):
        if (
            sig1.dt == sig2.dt
            and sig1.start_time == sig2.start_time
            and sig1.duration == sig2.duration
        ):
            s1, s2 = sig1.samples, sig2.samples
            nt = s1.shape[0]
            prod = 0.5 * (s1[:, :, None] * s2[:, None, :]).reshape(nt, -1)
            prod_conj = 0.5 * (s1[:, :, None] * s2[:, None, :].conj()).reshape(nt, -1)
            f1, f2 = unp.atleast_1d(sig1.carrier_freq), unp.atleast_1d(sig2.carrier_freq)
            p1, p2 = unp.atleast_1d(sig1.phase), unp.atleast_1d(sig2.phase)
            freqs = unp.concatenate(
                [(f1[:, None] + f2[None, :]).reshape(-1), (f1[:, None] - f2[None, :]).reshape(-1)]
            )
            phases = unp.concatenate(
                [(p1[:, None] + p2[None, :]).reshape(-1), (p1[:, None] - p2[None, :]).reshape(-1)]
            )
            return DiscreteSignalSum(
                dt=sig1.dt,
                samples=unp.concatenate([prod, prod_conj], axis=1),
                start_time=sig1.start_time,
                carrier_freq=freqs,
                phase=phases,
            )

    product = SignalSum()
    for comp1, comp2 in itertools.product(sig1.components, sig2.components):
        product += base_signal_multiply(comp1, comp2)
    return product


def base_signal_multiply(sig1: Signal, sig2: Signal) -> Signal:
    """Multiply two elementary signals (see ``signal_multiply``)."""
    sig1, sig2 = sort_signals(sig1, sig2)

    if sig1.is_constant and sig2.is_constant:
        return Signal(sig1(0.0) * sig2(0.0))
    if sig1.is_constant and type(sig2) is DiscreteSignal:
        return DiscreteSignal(
            dt=sig2.dt,
            samples=sig1(0.0) * sig2.samples,
            start_time=sig2.start_time,
            carrier_freq=sig2.carrier_freq,
            phase=sig2.phase,
        )
    if sig1.is_constant and type(sig2) is Signal:
        const = sig1(0.0)
        env2 = sig2._envelope
        return Signal(
            envelope=lambda t: const * env2(t), carrier_freq=sig2.carrier_freq, phase=sig2.phase
        )
    if type(sig1) is DiscreteSignal and type(sig2) is DiscreteSignal:
        if (
            sig1.start_time == sig2.start_time
            and sig1.dt == sig2.dt
            and sig1.samples.shape[0] == sig2.samples.shape[0]
        ):
            pwc1 = DiscreteSignal(
                dt=sig2.dt,
                samples=0.5 * sig1.samples * sig2.samples,
                start_time=sig2.start_time,
                carrier_freq=sig1.carrier_freq + sig2.carrier_freq,
                phase=sig1.phase + sig2.phase,
            )
            pwc2 = DiscreteSignal(
                dt=sig2.dt,
                samples=0.5 * sig1.samples * unp.conjugate(sig2.samples),
                start_time=sig2.start_time,
                carrier_freq=sig1.carrier_freq - sig2.carrier_freq,
                phase=sig1.phase - sig2.phase,
            )
            return pwc1 + pwc2

    env1, env2 = sig1._envelope, sig2._envelope
    prod1 = Signal(
        envelope=lambda t: 0.5 * env1(t) * env2(t),
        carrier_freq=sig1.carrier_freq + sig2.carrier_freq,
        phase=sig1.phase + sig2.phase,
    )
    prod2 = Signal(
        envelope=lambda t: 0.5 * env1(t) * unp.conjugate(env2(t)),
        carrier_freq=sig1.carrier_freq - sig2.carrier_freq,
        phase=sig1.phase - sig2.phase,
    )
    return prod1 + prod2


def sort_signals(sig1: Signal, sig2: Signal) -> Tuple[Signal, Signal]:
    """Order a signal pair: constant < DiscreteSignal < Signal < SignalSum < DiscreteSignalSum."""

    def rank(sig):
        if getattr(sig, "is_constant", False):
            return 0
        if isinstance(sig, DiscreteSignalSum):
            return 4
        if isinstance(sig, SignalSum):
            return 3
        if isinstance(sig, DiscreteSignal):
            return 1
        return 2

    if rank(sig2) < rank(sig1):
        return sig2, sig1
    return sig1, sig2


def to_SignalSum(sig) -> SignalSum:
    """Coerce a scalar / Signal / SignalSum into a SignalSum."""
    if isinstance(sig, DiscreteSignal) and not isinstance(sig, DiscreteSignalSum):
        samples = sig.samples
        if samples.shape == (0,):
            samples = samples[:, None] if samples.ndim == 1 else samples
        else:
            samples = samples[:, None]
        return DiscreteSignalSum(
            dt=sig.dt,
            samples=samples,
            start_time=sig.start_time,
            carrier_freq=unp.atleast_1d(sig.carrier_freq),
            phase=unp.atleast_1d(sig.phase),
        )
    if isinstance(sig, SignalSum):
        return sig
    if isinstance(sig, Signal):
        return SignalSum(sig)
    arr = unp.asarray(sig)
    if arr.ndim == 0:
        return SignalSum(Signal(arr))
    raise DynamicsError("Input type incompatible with SignalSum.")


for _cls in (Signal, DiscreteSignal, SignalSum, DiscreteSignalSum, SignalList):
    register_pytree_node(_cls, _cls.tree_flatten, _cls.tree_unflatten)
