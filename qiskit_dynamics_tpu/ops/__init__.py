"""Low-level compute kernels.

The hot paths of the framework live here: the batch-major XLA fixed-step
engine and its polynomial-expanded variant, the lockstep-adaptive dopri5
sweep (a Pallas Triton kernel with its XLA twin), the compensated
double-float32 engine, the recorded-grid AD replay, and the shared numeric
helpers (EFT phase reduction, RK tableaus, df32 arithmetic).
"""
from .linear_combo import linear_combo
from .expm import expm_taylor
from .xla_sweep import sweep_expm_magnus2_xla
from .adaptive_sweep import sweep_dopri5_lockstep
from .df_sweep import sweep_expm_magnus_df
from .chain_apply import chain_apply

__all__ = [
    "linear_combo",
    "expm_taylor",
    "sweep_expm_magnus2_xla",
    "sweep_dopri5_lockstep",
    "sweep_expm_magnus_df",
    "chain_apply",
]
