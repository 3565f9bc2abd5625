"""Data-parallel imitation-learning training steps.

The reference's training loop (SURVEY.md §3.5, upstream ``empc/`` imitation
scripts) is single-process; this module is its data-parallel scaling
equivalent (driver eval configs 3-5): the scenario batch is sharded over the
mesh, each device solves its shard's MPC problems, and the parameter
gradient is ``psum``-reduced across devices inside a ``shard_map`` — the
explicit form of the collective XLA would insert under GSPMD, kept explicit
so the communication pattern is visible and testable (SURVEY.md §5.8).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from ..mpc import mpc_solve
from ..types import MPCConfig
from .mesh import BATCH_AXIS


class TrainState(NamedTuple):
    params: object  # learnable problem parameters (dynamics and/or cost)
    opt_state: object


class StepStats(NamedTuple):
    loss: jnp.ndarray  # () global mean imitation loss
    grad_norm: jnp.ndarray  # () global gradient norm
    converged_frac: jnp.ndarray  # () fraction of converged solves (global)
    qp_residual: jnp.ndarray  # () global mean solver residual (last improvement)
    clamp_frac: jnp.ndarray  # () global mean clamped-control fraction


_NO_TASK = object()


def imitation_loss(
    config: MPCConfig,
    params,
    make_problem: Callable,
    x_init: jnp.ndarray,
    u_expert: jnp.ndarray,
    u_lower=None,
    u_upper=None,
    task=_NO_TASK,
):
    """MSE between learned-model MPC controls and expert controls
    (SURVEY.md §3.5). ``make_problem(params) -> (cost, dx)`` rebuilds the
    (differentiable) cost and dynamics from the learnable parameters —
    gradients flow through the analytic KKT backward of the final LQR step
    only, exactly like the reference's fixed-point semantics. When a
    ``task`` payload is given, ``make_problem(params, task)`` is called
    instead (per-scenario task data, e.g. randomized goals)."""
    cost, dx = make_problem(params) if task is _NO_TASK else make_problem(params, task)
    sol = mpc_solve(
        config, x_init, cost, dx, u_lower=u_lower, u_upper=u_upper
    )
    per_elem = jnp.mean((sol.us - u_expert) ** 2, axis=(0, 2))  # (B_local,)
    return jnp.mean(per_elem), sol.info


def _is_batched_leaf(a):
    """Axes leaves must be exactly 0 (scenario-batched) or None
    (replicated) — anything else (True/False, 1, strings) is ambiguous and
    silently wrong in one direction, so it is rejected loudly."""
    if a is None:
        return False
    if type(a) is int and a == 0:
        return True
    raise ValueError(
        f"params_batch_axes leaves must be 0 (scenario-batched, sharded "
        f"with the batch) or None (replicated); got {a!r}"
    )


def _params_spec(params_batch_axes):
    """``vmap``-``in_axes``-style axes tree -> shard_map PartitionSpec tree
    (a pytree prefix of the params): ``0`` leaves shard with the batch,
    ``None`` leaves replicate."""
    if params_batch_axes is None:
        return P()
    if type(params_batch_axes) is int:
        return P(BATCH_AXIS) if _is_batched_leaf(params_batch_axes) else P()
    return jax.tree_util.tree_map(
        lambda a: P(BATCH_AXIS) if _is_batched_leaf(a) else P(),
        params_batch_axes,
        is_leaf=lambda x: x is None,
    )


def _task_spec(task_batch_axes):
    """Task-payload axes tree -> shard_map PartitionSpec tree. Each leaf is
    the position of the scenario-batch axis in that task leaf (``0`` for a
    ``(B, ...)`` goals array, ``1`` for a ``(T, B, nm)`` cost vector, ...) or
    ``None`` for a replicated leaf."""

    def one(a):
        if a is None:
            return P()
        if type(a) is int and a >= 0:
            return P(*([None] * a), BATCH_AXIS)
        raise ValueError(
            f"task_batch_axes leaves must be a non-negative int (position "
            f"of the scenario-batch axis) or None (replicated); got {a!r}"
        )

    if task_batch_axes is None or type(task_batch_axes) is int:
        return one(task_batch_axes)
    return jax.tree_util.tree_map(one, task_batch_axes, is_leaf=lambda x: x is None)


def _reduce_grads(grads, params_batch_axes):
    """Cross-device gradient reduction (non-VMA mode only). Replicated
    leaves pmean to the global-batch gradient. Scenario-batched leaves stay
    local — each row belongs to exactly one scenario on one device, so a
    cross-device mean would mix unrelated scenarios — and only rescale from
    the local-mean to the global-mean loss."""
    if params_batch_axes is None:
        return jax.lax.pmean(grads, BATCH_AXIS)
    n_dev = jax.lax.psum(1, BATCH_AXIS)

    def one(g, a):
        return g / n_dev if _is_batched_leaf(a) else jax.lax.pmean(g, BATCH_AXIS)

    if type(params_batch_axes) is int:
        return jax.tree_util.tree_map(lambda g: one(g, params_batch_axes), grads)
    # axes tree first: it may be a prefix of grads, in which case each axes
    # leaf governs a whole grads subtree
    return jax.tree_util.tree_map(
        lambda a, sub: jax.tree_util.tree_map(lambda g: one(g, a), sub),
        params_batch_axes,
        grads,
        is_leaf=lambda x: x is None,
    )


def make_dp_train_step(
    config: MPCConfig,
    make_problem: Callable,
    optimizer: optax.GradientTransformation,
    mesh: Optional[Mesh] = None,
    u_lower=None,
    u_upper=None,
    check_vma: Optional[bool] = None,
    params_batch_axes=None,
    task_batch_axes=_NO_TASK,
):
    """Build a jitted (optionally data-parallel) imitation train step.

    Returns ``step(state, x_init, u_expert) -> (state, StepStats)`` where
    ``x_init (B, n)`` / ``u_expert (T, B, m)`` are globally sharded on the
    batch axis when a ``mesh`` is given. Inside ``shard_map`` each device
    computes its local loss gradient; ``jax.lax.pmean`` over the batch axis
    reduces gradients and stats across devices.
    With ``mesh=None`` the same step runs single-device (the reference's
    whole parallelism story — SURVEY.md §2.3).

    ``params_batch_axes`` marks learnable-params leaves that carry a leading
    scenario axis (per-scenario / domain-randomized params, aligned with the
    solve batch): ``None`` (default) — all leaves are scenario-independent
    and replicated on the mesh; ``0`` — every leaf is scenario-batched and
    sharded with the batch; or a pytree prefix of the params with ``0`` /
    ``None`` leaves mixing the two (``vmap``-``in_axes`` style). Scenario-
    batched gradient rows live on the device that owns the scenario — they
    are never summed across devices (each row belongs to one scenario), so
    the reduction differs from the replicated-leaf ``pmean``; both are
    handled here for both ``check_vma`` modes.

    ``task_batch_axes`` (when given) enables a NON-learnable per-scenario
    task payload (task randomization: per-scenario goals, setpoints, cost
    vectors): the returned step becomes
    ``step(state, x_init, u_expert, task)`` and ``make_problem`` is called
    as ``make_problem(params, task)``. The axes value is a pytree prefix of
    the task whose leaves give the position of the scenario-batch axis in
    each task leaf (``0`` for ``(B, ...)`` goals, ``1`` for a ``(T, B, nm)``
    cost vector) or ``None`` for replicated leaves — a closed-over
    per-scenario array cannot shard under ``shard_map``, which is why the
    payload is threaded explicitly. Unlike ``params_batch_axes`` this may
    name any axis position (tasks are data, never differentiated).
    """
    has_task = task_batch_axes is not _NO_TASK

    if mesh is not None and check_vma is None:
        # On the XLA path the full varying-manual-axes checker runs: every
        # literal-initialized solver carry is VMA-promoted at its init site
        # (utils.batch.match_vma) and the Pallas kernels type their outputs
        # (ops.pallas.riccati.out_struct), so replication bugs inside the
        # solve are caught at trace time rather than silently miscomputed.
        # When the Pallas kernels engage the checker must be off: JAX
        # traces pallas kernel BODIES inside the manual-axes context where
        # ref reads are VMA-typed inconsistently (the strict xfail in
        # tests/test_pallas_sharding.py fires the day that changes).
        # The platform comes from the MESH's devices, not the process
        # default backend.
        from ..ops.lqr_step import use_kernels

        check_vma = not use_kernels(
            config.use_pallas,
            config.pallas_interpret,
            mesh.devices.flat[0].platform,
        )

    def local_grads(params, x_init, u_expert, task=_NO_TASK):
        def loss_fn(p):
            loss, info = imitation_loss(
                config, p, make_problem, x_init, u_expert, u_lower, u_upper,
                task=task,
            )
            if mesh is not None and check_vma:
                # VMA mode: form the global-mean loss INSIDE the
                # differentiated function (SURVEY.md §2.3 "communication
                # backend" row: pmean is the gradient reduction the
                # reference never had). Under
                # varying-manual-axes typing the cotangent of a replicated
                # parameter is psum'd across devices by the transpose of
                # the implicit varying-promotion, so differentiating the
                # pmean'd loss yields exactly the global-batch gradient; a
                # post-hoc pmean-of-grads (the pre-VMA idiom) would leave
                # an n_devices-times-too-large sum.
                loss = jax.lax.pmean(loss, BATCH_AXIS)
            return loss, info

        (loss, info), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        conv = jnp.mean(info.converged.astype(jnp.float32))
        # Solver-health stats (SURVEY.md §5.5): mean last-iteration
        # improvement (the solve residual) and clamped-control fraction.
        resid = jnp.mean(
            jnp.where(jnp.isfinite(info.last_improvement),
                      jnp.abs(info.last_improvement), 0.0)
        )
        clamp = jnp.mean(info.clamp_frac)
        if mesh is not None:
            if not check_vma:
                # non-VMA mode: psum's transpose is identity, so the grad
                # of a pmean'd loss would stay an unreduced per-device
                # local gradient — reduce explicitly AFTER differentiation
                # instead (the classic idiom). Both modes are pinned by
                # tests/test_sharding.py agreement tests. Scenario-batched
                # leaves instead rescale local-mean -> global-mean (their
                # rows never cross devices); in VMA mode both leaf kinds
                # come out right automatically from the pmean'd loss
                # (replicated: pvary-transpose psum; batched: local rows of
                # the global-mean gradient).
                loss = jax.lax.pmean(loss, BATCH_AXIS)
                grads = _reduce_grads(grads, params_batch_axes)
            conv = jax.lax.pmean(conv, BATCH_AXIS)
            resid = jax.lax.pmean(resid, BATCH_AXIS)
            clamp = jax.lax.pmean(clamp, BATCH_AXIS)
        return loss, grads, conv, resid, clamp

    if mesh is not None:
        params_spec = _params_spec(params_batch_axes)
        in_specs = (params_spec, P(BATCH_AXIS), P(None, BATCH_AXIS))
        if has_task:
            in_specs = in_specs + (_task_spec(task_batch_axes),)
        grads_fn = jax.shard_map(
            local_grads,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=(P(), params_spec, P(), P(), P()),
            check_vma=check_vma,
        )
    else:
        grads_fn = local_grads

    if has_task:

        @jax.jit
        def step(state: TrainState, x_init, u_expert, task):
            loss, grads, conv, resid, clamp = grads_fn(
                state.params, x_init, u_expert, task
            )
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
            params = optax.apply_updates(state.params, updates)
            gnorm = optax.global_norm(grads)
            return TrainState(params, opt_state), StepStats(
                loss, gnorm, conv, resid, clamp
            )

        return step

    @jax.jit
    def step(state: TrainState, x_init, u_expert):
        loss, grads, conv, resid, clamp = grads_fn(state.params, x_init, u_expert)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        gnorm = optax.global_norm(grads)
        return TrainState(params, opt_state), StepStats(loss, gnorm, conv, resid, clamp)

    return step


def init_train_state(params, optimizer: optax.GradientTransformation) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params))


def generate_expert_data(
    config: MPCConfig,
    cost,
    dx,
    x_init: jnp.ndarray,
    u_lower=None,
    u_upper=None,
):
    """Run MPC with the TRUE cost/dynamics to produce expert trajectories
    (the reference's expert-data-generation script, SURVEY.md §2.1 C8)."""
    sol = mpc_solve(config, x_init, cost, dx, u_lower=u_lower, u_upper=u_upper)
    return sol.xs, sol.us, sol.objs
