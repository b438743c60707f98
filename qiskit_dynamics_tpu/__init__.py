"""qiskit_dynamics_tpu: accelerator-native time-dependent quantum dynamics.

A from-scratch JAX/XLA/Pallas framework with the capability set of
qiskit-dynamics (reference: ``/root/reference/qiskit_dynamics/__init__.py``):
signals, Hamiltonian/Lindblad models with rotating frames and RWA,
fixed-step/adaptive/perturbative solvers, a pulse-schedule front end, and a
backend simulation layer — all jit-native, with fused sweep engines for
the GPU and multi-device sharding via ``parallel``.
"""
import os as _os

with open(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)), "VERSION.txt")) as _f:
    __version__ = _f.read().strip()

from .exceptions import DynamicsError
from .dtypes import ArrayLike
from .arraylias import (
    DYNAMICS_NUMPY,
    DYNAMICS_NUMPY_ALIAS,
    DYNAMICS_SCIPY,
    DYNAMICS_SCIPY_ALIAS,
    ArrayLike,
    requires_array_library,
)
from .models import RotatingFrame
from .signals import Signal, DiscreteSignal
from .solvers import solve_ode, solve_lmde, Solver, OdeResult, DysonSolver, MagnusSolver
from .perturbation import solve_lmde_perturbation, ArrayPolynomial
from .utils import cjit

from . import models
from . import signals
from . import solvers
from . import pulse
from . import quantum_info
from .backend import DynamicsBackend

from . import utils
from . import parallel
from . import perturbation
from . import backend
