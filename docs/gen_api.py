"""Generate the markdown API reference (docs/api/) from the live package.

Sphinx is not available in this environment, so this renders the same
content the reference's ``docs/apidocs`` sphinx pages provide
(``/root/reference/docs/apidocs/*.rst``: one page per subpackage, public
symbols with signatures and docstrings) as plain markdown.

Usage:  PYTHONPATH=. python docs/gen_api.py
"""
from __future__ import annotations

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: page -> (title, module, explicit symbol list or None for module __all__)
PAGES = {
    "signals": (
        "Signals (`qiskit_dynamics_tpu.signals`)",
        "qiskit_dynamics_tpu.signals",
        ["Signal", "DiscreteSignal", "SignalSum", "DiscreteSignalSum", "SignalList",
         "Convolution", "FFTConvolution", "Sampler", "IQMixer"],
    ),
    "models": (
        "Models (`qiskit_dynamics_tpu.models`)",
        "qiskit_dynamics_tpu.models",
        ["GeneratorModel", "HamiltonianModel", "LindbladModel", "RotatingFrame",
         "rotating_wave_approximation"],
    ),
    "solvers": (
        "Solvers (`qiskit_dynamics_tpu.solvers`)",
        "qiskit_dynamics_tpu.solvers",
        ["solve_ode", "solve_lmde", "Solver", "tpu_dopri5", "tpu_dop853",
         "tpu_rk_solve", "fused_sweep_solve", "fused_adaptive_sweep_solve",
         "interpolated_sweep_solve", "DysonSolver", "MagnusSolver",
         "ExpansionModel", "optimize_controls", "OptimizeResult",
         "state_infidelity", "unitary_infidelity",
         "lindblad_steady_state", "lindblad_steady_state_iterative",
         "lindblad_steady_state_sweep", "floquet_basis",
         "correlation_function", "spectrum", "spectrum_iterative",
         "solve_mc_trajectories", "solve_mc_trajectories_sweep",
         "mc_expectation"],
    ),
    "perturbation": (
        "Perturbation theory (`qiskit_dynamics_tpu.perturbation`)",
        "qiskit_dynamics_tpu.perturbation",
        None,
    ),
    "pulse": (
        "Pulse front end (`qiskit_dynamics_tpu.pulse`)",
        "qiskit_dynamics_tpu.pulse",
        ["InstructionToSignals", "Schedule", "Play", "ShiftPhase", "SetPhase",
         "ShiftFrequency", "SetFrequency", "Waveform", "DriveChannel",
         "ControlChannel", "MeasureChannel", "AcquireChannel"],
    ),
    "backend": (
        "Backend (`qiskit_dynamics_tpu.backend`)",
        "qiskit_dynamics_tpu.backend",
        ["DynamicsBackend", "DynamicsJob", "parse_backend_hamiltonian_dict",
         "default_experiment_result_function"],
    ),
    "ops": (
        "Compute engines (`qiskit_dynamics_tpu.ops`)",
        "qiskit_dynamics_tpu.ops",
        None,
    ),
    "parallel": (
        "Multi-chip parallelism (`qiskit_dynamics_tpu.parallel`)",
        "qiskit_dynamics_tpu.parallel",
        None,
    ),
    "arraylias": (
        "Array dispatch (`qiskit_dynamics_tpu` core + arraylias compat)",
        "qiskit_dynamics_tpu",
        ["DYNAMICS_NUMPY", "DYNAMICS_SCIPY", "requires_array_library"],
    ),
}


def render_symbol(name, obj) -> str:
    lines = []
    if inspect.isclass(obj):
        lines.append(f"### `{name}`\n")
        doc = inspect.getdoc(obj) or "(no docstring)"
        lines.append(doc + "\n")
        try:
            sig = str(inspect.signature(obj.__init__))
            lines.append(f"**Constructor:** `{name}{sig.replace('(self, ', '(').replace('(self)', '()')}`\n")
        except (ValueError, TypeError):
            pass
        methods = []
        for mname, m in sorted(vars(obj).items()):
            if mname.startswith("_") or not callable(m):
                continue
            mdoc = inspect.getdoc(m)
            head = mdoc.splitlines()[0] if mdoc else ""
            try:
                msig = str(inspect.signature(m)).replace("(self, ", "(").replace("(self)", "()")
            except (ValueError, TypeError):
                msig = "(...)"
            methods.append(f"- `{mname}{msig}` — {head}")
        if methods:
            lines.append("**Methods:**\n")
            lines.extend(methods)
            lines.append("")
    elif callable(obj):
        try:
            sig = str(inspect.signature(obj))
        except (ValueError, TypeError):
            sig = "(...)"
        lines.append(f"### `{name}{sig}`\n")
        lines.append((inspect.getdoc(obj) or "(no docstring)") + "\n")
    else:
        lines.append(f"### `{name}`\n")
        lines.append((inspect.getdoc(type(obj)) or str(obj)) + "\n")
    return "\n".join(lines)


def main():
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "api")
    os.makedirs(out_dir, exist_ok=True)
    index = [
        "# API reference\n",
        "Generated from the live package docstrings by `docs/gen_api.py` "
        "(`PYTHONPATH=. python docs/gen_api.py`). One page per subpackage, "
        "mirroring the reference's sphinx apidocs layout "
        "(`/root/reference/docs/apidocs/`).\n",
    ]
    for page, (title, module, symbols) in PAGES.items():
        mod = importlib.import_module(module)
        if symbols is None:
            symbols = sorted(getattr(mod, "__all__", [])) or sorted(
                n for n in vars(mod) if not n.startswith("_")
            )
        body = [f"# {title}\n"]
        mdoc = inspect.getdoc(mod)
        if mdoc:
            body.append(mdoc + "\n")
        for name in symbols:
            obj = getattr(mod, name, None)
            if obj is None:
                continue
            body.append(render_symbol(name, obj))
        with open(os.path.join(out_dir, f"{page}.md"), "w") as fh:
            fh.write("\n".join(body))
        index.append(f"- [{title}]({page}.md)")
        print(f"wrote api/{page}.md ({len(symbols)} symbols)")
    with open(os.path.join(out_dir, "index.md"), "w") as fh:
        fh.write("\n".join(index) + "\n")


if __name__ == "__main__":
    main()
