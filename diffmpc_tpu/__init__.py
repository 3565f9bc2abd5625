"""tpu-diffmpc: a differentiable-MPC engine for accelerators (NVIDIA GPUs).

Built from scratch in JAX/XLA/Pallas with the capabilities of
``pfnet-research/chainer-differentiable-mpc`` (Amos et al., NeurIPS 2018
differentiable MPC) — see SURVEY.md for the reference analysis and
docs/DESIGN.md for the design rationale.
"""

from .mpc import MPC, MPCInfo, MPCSolution, mpc_solve
from .receding import (
    RecedingState,
    receding_init,
    receding_step,
    run_receding_horizon,
)
from .types import GradMethods, LinDx, LineSearchConfig, MPCConfig, QuadCost

__version__ = "0.1.0"

__all__ = [
    "MPC",
    "MPCConfig",
    "MPCInfo",
    "MPCSolution",
    "GradMethods",
    "LinDx",
    "LineSearchConfig",
    "QuadCost",
    "RecedingState",
    "mpc_solve",
    "receding_init",
    "receding_step",
    "run_receding_horizon",
]
