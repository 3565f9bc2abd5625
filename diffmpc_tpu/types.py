"""Core problem types for the differentiable-MPC engine.

Capability parity with the reference's type surface
(``pfnet-research/chainer-differentiable-mpc``, see SURVEY.md §2.1 C4:
``mpc/mpc.py`` defines ``QuadCost``, ``LinDx``, ``GradMethods`` plus the MPC
constructor knobs). Re-designed for JAX: costs/dynamics are registered JAX
pytrees so they flow through ``jit``/``vmap``/``shard_map`` unchanged, and all
solver knobs live in a hashable frozen dataclass usable as a static jit
argument.

Canonical shape contract (SURVEY.md §2.2), with horizon ``T``, batch ``B``,
state dim ``n``, control dim ``m`` and tau_t = [x_t; u_t] in R^{n+m}:

- ``QuadCost.C``: ``(T, B, n+m, n+m)`` (PSD per slice), ``QuadCost.c``:
  ``(T, B, n+m)``
- ``LinDx.F``: ``(T, B, n, n+m)``, ``LinDx.f``: ``(T, B, n)``; semantics
  ``x_{t+1} = F_t @ tau_t + f_t`` (the ``t = T-1`` slice is unused).
- ``x_init``: ``(B, n)``; returns ``x*: (T, B, n)``, ``u*: (T, B, m)``,
  ``objs: (B,)``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional

import jax.numpy as jnp


class QuadCost(NamedTuple):
    """Time-varying quadratic cost 0.5 * tau' C tau + c' tau.

    ``C``: ``(T, B, n+m, n+m)`` or unbatched/untimed variants accepted by
    :func:`diffmpc_tpu.mpc.MPC` (expanded on entry). ``c``: ``(T, B, n+m)``.
    """

    C: jnp.ndarray
    c: jnp.ndarray


class LinDx(NamedTuple):
    """Time-varying affine dynamics x_{t+1} = F_t tau_t + f_t.

    ``F``: ``(T, B, n, n+m)``; ``f``: ``(T, B, n)`` (may be zeros).
    """

    F: jnp.ndarray
    f: Optional[jnp.ndarray] = None


class GradMethods(enum.Enum):
    """How to linearize nonlinear dynamics inside the iLQR loop.

    Mirrors the reference's ``GradMethods`` enum (SURVEY.md §2.1 C4). Under
    JAX, ``AUTO_DIFF`` uses vmapped ``jacfwd`` (exact, compiled — there is no
    tape-unrolling cost distinction like in define-by-run frameworks),
    ``ANALYTIC`` calls the model's hand-written ``grad_input``,
    ``FINITE_DIFF`` uses central differences (kept for parity testing), and
    ``ANALYTIC_CHECK`` computes both analytic and autodiff Jacobians and
    raises if they disagree.
    """

    AUTO_DIFF = "auto_diff"
    ANALYTIC = "analytic"
    FINITE_DIFF = "finite_diff"
    ANALYTIC_CHECK = "analytic_check"


@dataclasses.dataclass(frozen=True)
class LineSearchConfig:
    """Vectorized Armijo backtracking configuration.

    The reference backtracks per batch element sequentially
    (``lqr_step.py: lqr_forward``); here we evaluate the full geometric
    alpha-ladder ``decay**k, k < max_iter`` for every batch element in one
    batched rollout and select per-element the first improving step — same
    accept rule, fixed trip count (SURVEY.md §7 stage 5).
    """

    decay: float = 0.2
    max_iter: int = 10


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Static solver configuration — the reference's ~20 constructor knobs.

    One-to-one with the ``MPC.__init__`` kwargs of the reference
    (SURVEY.md §2.1 C4, ``mpc/mpc.py``); hashable so it can be a static
    argument to ``jax.jit``.
    """

    n_state: int
    n_ctrl: int
    T: int
    lqr_iter: int = 10
    grad_method: GradMethods = GradMethods.ANALYTIC
    delta_u: Optional[float] = None
    verbose: int = 0
    eps: float = 1e-7
    back_eps: float = 1e-7
    linesearch_decay: float = 0.2
    max_linesearch_iter: int = 10
    exit_unconverged: bool = True
    detach_unconverged: bool = True
    backprop: bool = True
    not_improved_lim: int = 5
    best_cost_eps: float = 1e-4
    slew_rate_penalty: Optional[float] = None
    # Inner projected-Newton QP (SURVEY.md §2.1 C2)
    pnqp_iter: int = 20
    # Tolerance used to detect tight (active) box constraints in the KKT
    # backward pass.
    tight_eps: float = 1e-6
    # Advisory record of the intended compute dtype: the solver actually
    # follows ``x_init.dtype`` (pass f64 arrays on CPU for high-accuracy
    # parity fixtures — SURVEY.md §7 hard-part 3; f32 is the GPU path).
    dtype: jnp.dtype = jnp.float32
    # Pallas kernels (the fused iLQR solve and the KKT backward, Triton
    # route). None = auto: on for the GPU, off on the CPU (the XLA path);
    # see diffmpc_tpu.ops.lqr_step.use_kernels for the platform table.
    use_pallas: Optional[bool] = None
    # Run the Pallas kernels in interpret mode (CPU-executable). Testing
    # knob: lets the GPU kernel path — including its composition with
    # shard_map — run on the virtual CPU mesh.
    pallas_interpret: bool = False

    @property
    def n_tau(self) -> int:
        return self.n_state + self.n_ctrl

    @property
    def linesearch(self) -> LineSearchConfig:
        return LineSearchConfig(self.linesearch_decay, self.max_linesearch_iter)
