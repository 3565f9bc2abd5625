"""Multi-device sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §4 "multi-host tests run the same seeded problem at 1 and N
devices and assert agreement of the gathered result")."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from diffmpc_tpu import MPCConfig, QuadCost, mpc_solve
from diffmpc_tpu.models import PendulumDx
from diffmpc_tpu.parallel import (
    batch_sharding,
    init_train_state,
    make_dp_train_step,
    make_mesh,
    shard_batch,
)


@pytest.fixture(scope="module")
def problem():
    # f64: the single-device and partitioned programs are separate XLA
    # compilations whose f32 fusion/reassociation differences can flip a
    # discrete line-search branch; in f64 the branch decisions are stable
    # and 1-vs-N-device agreement is exact to solver tolerance.
    dtype = jnp.float64
    B, T = 32, 10
    dx = PendulumDx.default(dtype)
    q, p = dx.get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    # eps=0 + huge not_improved_lim: every element runs exactly lqr_iter
    # iterations in both compilations, keeping discrete branches (line-search
    # accepts, convergence exits) far from numerical ties.
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=6, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False, dtype=dtype,
    )
    rng = np.random.default_rng(50)
    th = rng.uniform(-np.pi, np.pi, B)
    thdot = rng.uniform(-1, 1, B)
    x_init = jnp.asarray(np.stack([np.cos(th), np.sin(th), thdot], -1), dtype)
    return config, cost, dx, x_init


def test_eight_devices_available():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"


def test_sharded_solve_matches_single_device(problem):
    config, cost, dx, x_init = problem
    mesh = make_mesh()

    solve = jax.jit(lambda x: mpc_solve(config, x, cost, dx, u_lower=-2.0, u_upper=2.0))
    ref = solve(x_init)

    x_sharded = jax.device_put(x_init, batch_sharding(mesh, 0, 2))
    out = solve(x_sharded)
    np.testing.assert_allclose(np.asarray(out.us), np.asarray(ref.us), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.xs), np.asarray(ref.xs), atol=1e-6)
    # result really was computed under the mesh sharding
    assert len(out.us.sharding.device_set) >= 1


def test_dp_train_step_matches_single_device(problem):
    """Sharded shard_map+pmean training step == single-device step
    (same seeded problem at 1 and N devices; SURVEY.md §4)."""
    config, cost, dx, x_init = problem
    T = config.T
    B = x_init.shape[0]
    u_expert = jnp.zeros((T, B, 1), x_init.dtype)

    def make_problem(params):
        return cost, dx.replace(params=params)

    opt = optax.sgd(1e-2)
    mesh = make_mesh()
    step_1 = make_dp_train_step(config, make_problem, opt, None, -2.0, 2.0)
    step_n = make_dp_train_step(config, make_problem, opt, mesh, -2.0, 2.0)

    s0 = init_train_state(dx.params, opt)
    s1, st1 = step_1(s0, x_init, u_expert)
    sn, stn = step_n(
        s0, shard_batch(mesh, x_init, 0), shard_batch(mesh, u_expert, 1)
    )
    np.testing.assert_allclose(float(stn.loss), float(st1.loss), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(sn.params), np.asarray(s1.params), atol=1e-7
    )
    np.testing.assert_allclose(
        float(stn.grad_norm), float(st1.grad_norm), rtol=1e-5
    )


def test_scaling_batch_shards_evenly():
    """65k-scenario shape (driver eval config 5, scaled down): solve with
    B=1024 sharded over 8 devices — each device sees B/8."""
    dtype = jnp.float32
    B, T = 1024, 5
    dx = PendulumDx.default(dtype)
    q, p = dx.get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=2, eps=1e-4,
        exit_unconverged=False, dtype=dtype,
    )
    rng = np.random.default_rng(51)
    th = rng.uniform(-np.pi, np.pi, B)
    x_init = jnp.asarray(np.stack([np.cos(th), np.sin(th), 0 * th], -1), dtype)
    mesh = make_mesh()
    xs = jax.device_put(x_init, batch_sharding(mesh, 0, 2))
    sol = jax.jit(lambda x: mpc_solve(config, x, cost, dx, u_lower=-2.0, u_upper=2.0))(xs)
    assert sol.us.shape == (T, B, 1)
    assert bool(jnp.all(jnp.isfinite(sol.us)))
    # output batch axis stays sharded over all 8 devices
    assert len(sol.xs.sharding.device_set) == 8


def test_dp_train_step_config5_ensemble_shape():
    """Driver eval config 5 (BASELINE.md row 3: the 65,536-scenario
    domain-randomized ensemble), scaled down per-device for the virtual
    mesh: T=20 horizon, per-scenario physics params (``params_batch_axes=0``)
    sharded with the batch over all 8 devices, B_global=512 (64/device —
    the same per-device SHAPE class as 65k/8 on a real pod, smaller only in
    the tile count). Pins the exact composition the scale shape exercises:
    sharded per-scenario param rows + replicated optimizer + pmean'd stats."""
    dtype = jnp.float32
    B, T = 512, 20
    dx = PendulumDx.default(dtype)
    q, p = dx.get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=3, eps=1e-5,
        exit_unconverged=False, detach_unconverged=False, dtype=dtype,
    )
    rng = np.random.default_rng(53)
    th = rng.uniform(-np.pi, np.pi, B)
    thdot = rng.uniform(-1, 1, B)
    x_init = jnp.asarray(np.stack([np.cos(th), np.sin(th), thdot], -1), dtype)
    u_expert = jnp.zeros((T, B, 1), dtype)
    # per-scenario (g, m, l) ensemble — each scenario learns its own physics
    base = np.asarray(dx.params, np.float32)
    params_b = jnp.asarray(
        base[None, :] * (1.0 + 0.05 * rng.standard_normal((B, base.size))),
        dtype,
    )

    def make_problem(params):
        return cost, dx.replace(params=params)

    opt = optax.sgd(1e-2)
    mesh = make_mesh()
    step_1 = make_dp_train_step(
        config, make_problem, opt, None, -2.0, 2.0, params_batch_axes=0
    )
    step_n = make_dp_train_step(
        config, make_problem, opt, mesh, -2.0, 2.0, params_batch_axes=0
    )

    s0 = init_train_state(params_b, opt)
    s0_n = init_train_state(shard_batch(mesh, params_b, 0), opt)
    s1, st1 = step_1(s0, x_init, u_expert)
    sn, stn = step_n(
        s0_n, shard_batch(mesh, x_init, 0), shard_batch(mesh, u_expert, 1)
    )
    np.testing.assert_allclose(float(stn.loss), float(st1.loss), rtol=1e-3)
    np.testing.assert_allclose(
        np.asarray(sn.params), np.asarray(s1.params), rtol=1e-3, atol=1e-4
    )
    # param rows stay sharded across all 8 devices (they scale with B)
    assert len(sn.params.sharding.device_set) == 8


def test_dp_train_step_f32_realistic_regime():
    """the realistic configuration — f32, default eps,
    finite not_improved_lim, check_vma=True (training.py) — agrees between
    1 and 8 devices to stated tolerances. Unlike the f64 exact test above,
    discrete branches (line-search accepts, convergence exits) may flip on
    f32 compilation differences, so agreement is tolerance-based."""
    dtype = jnp.float32
    B, T = 32, 10
    dx = PendulumDx.default(dtype)
    q, p = dx.get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=10,
        exit_unconverged=False, detach_unconverged=False, dtype=dtype,
    )
    rng = np.random.default_rng(52)
    th = rng.uniform(-np.pi, np.pi, B)
    thdot = rng.uniform(-1, 1, B)
    x_init = jnp.asarray(np.stack([np.cos(th), np.sin(th), thdot], -1), dtype)
    u_expert = jnp.zeros((T, B, 1), dtype)

    def make_problem(params):
        return cost, dx.replace(params=params)

    opt = optax.sgd(1e-2)
    mesh = make_mesh()
    step_1 = make_dp_train_step(config, make_problem, opt, None, -2.0, 2.0)
    step_n = make_dp_train_step(config, make_problem, opt, mesh, -2.0, 2.0)

    s0 = init_train_state(dx.params, opt)
    s1, st1 = step_1(s0, x_init, u_expert)
    sn, stn = step_n(
        s0, shard_batch(mesh, x_init, 0), shard_batch(mesh, u_expert, 1)
    )
    np.testing.assert_allclose(float(stn.loss), float(st1.loss), rtol=1e-3)
    np.testing.assert_allclose(
        np.asarray(sn.params), np.asarray(s1.params), rtol=1e-3, atol=1e-4
    )
    np.testing.assert_allclose(
        float(stn.grad_norm), float(st1.grad_norm), rtol=5e-3
    )
    np.testing.assert_allclose(
        float(stn.converged_frac), float(st1.converged_frac), atol=0.25
    )


def test_dp_train_step_both_vma_modes_agree(problem):
    """The gradient-reduction idiom must match the VMA mode (pmean-inside-
    loss under check_vma=True, pmean-of-grads under False — the transpose
    of the varying-promotion differs); both must equal the single-device
    step. Regression for the 8x-gradient bug the VMA migration exposed."""
    config, cost, dx, x_init = problem
    T, B = config.T, x_init.shape[0]
    u_expert = jnp.zeros((T, B, 1), x_init.dtype)

    def make_problem(params):
        return cost, dx.replace(params=params)

    opt = optax.sgd(1e-2)
    mesh = make_mesh()
    s0 = init_train_state(dx.params, opt)
    s1, st1 = make_dp_train_step(config, make_problem, opt, None, -2.0, 2.0)(
        s0, x_init, u_expert
    )
    for cv in (True, False):
        sn, stn = make_dp_train_step(
            config, make_problem, opt, mesh, -2.0, 2.0, check_vma=cv
        )(s0, shard_batch(mesh, x_init, 0), shard_batch(mesh, u_expert, 1))
        np.testing.assert_allclose(
            np.asarray(sn.params), np.asarray(s1.params), atol=1e-7,
            err_msg=f"check_vma={cv}",
        )
        np.testing.assert_allclose(
            float(stn.grad_norm), float(st1.grad_norm), rtol=1e-6,
            err_msg=f"check_vma={cv}",
        )


def test_dp_train_step_per_scenario_params(problem):
    """Per-scenario (domain-randomized) learnable params shard WITH the
    batch (params_batch_axes=0): each device owns its scenarios' parameter
    rows, and gradient rows must never be pmean'd across devices (that
    would mix unrelated scenarios). Both VMA modes must equal the
    single-device step exactly (f64 branch-stable config)."""
    config, cost, dx, x_init = problem
    T, B = config.T, x_init.shape[0]
    u_expert = jnp.zeros((T, B, 1), x_init.dtype)
    rng = np.random.default_rng(53)
    params_b = jnp.asarray(
        np.asarray(dx.params) * rng.uniform(0.9, 1.1, (B, 3)), x_init.dtype
    )

    def make_problem(params):
        return cost, dx.replace(params=params)

    opt = optax.sgd(1e-2)
    mesh = make_mesh()
    s0 = init_train_state(params_b, opt)
    s1, st1 = make_dp_train_step(config, make_problem, opt, None, -2.0, 2.0)(
        s0, x_init, u_expert
    )
    assert s1.params.shape == (B, 3)
    for cv in (True, False):
        step_n = make_dp_train_step(
            config, make_problem, opt, mesh, -2.0, 2.0,
            check_vma=cv, params_batch_axes=0,
        )
        sn, stn = step_n(
            init_train_state(shard_batch(mesh, params_b, 0), opt),
            shard_batch(mesh, x_init, 0),
            shard_batch(mesh, u_expert, 1),
        )
        np.testing.assert_allclose(
            np.asarray(sn.params), np.asarray(s1.params), atol=1e-7,
            err_msg=f"check_vma={cv}",
        )
        np.testing.assert_allclose(
            float(stn.loss), float(st1.loss), rtol=1e-9,
            err_msg=f"check_vma={cv}",
        )
        np.testing.assert_allclose(
            float(stn.grad_norm), float(st1.grad_norm), rtol=1e-6,
            err_msg=f"check_vma={cv}",
        )


def test_dp_train_step_mixed_params_axes(problem):
    """Mixed learnable-params pytree: a per-scenario (B, 3) leaf (sharded,
    axes 0) plus a shared (3,) bias leaf (replicated, axes None) trained
    together; gradients of both must match the single-device step in both
    VMA modes."""
    config, cost, dx, x_init = problem
    T, B = config.T, x_init.shape[0]
    u_expert = jnp.zeros((T, B, 1), x_init.dtype)
    rng = np.random.default_rng(54)
    params0 = {
        "dyn": jnp.asarray(
            np.asarray(dx.params) * rng.uniform(0.9, 1.1, (B, 3)), x_init.dtype
        ),
        "bias": jnp.asarray([0.1, -0.05, 0.02], x_init.dtype),
    }
    axes = {"dyn": 0, "bias": None}

    def make_problem(params):
        return cost, dx.replace(params=params["dyn"] + params["bias"])

    opt = optax.sgd(1e-2)
    mesh = make_mesh()
    s0 = init_train_state(params0, opt)
    s1, st1 = make_dp_train_step(config, make_problem, opt, None, -2.0, 2.0)(
        s0, x_init, u_expert
    )
    for cv in (True, False):
        step_n = make_dp_train_step(
            config, make_problem, opt, mesh, -2.0, 2.0,
            check_vma=cv, params_batch_axes=axes,
        )
        sharded0 = {
            "dyn": shard_batch(mesh, params0["dyn"], 0),
            "bias": params0["bias"],
        }
        sn, stn = step_n(
            init_train_state(sharded0, opt),
            shard_batch(mesh, x_init, 0),
            shard_batch(mesh, u_expert, 1),
        )
        for k in ("dyn", "bias"):
            np.testing.assert_allclose(
                np.asarray(sn.params[k]), np.asarray(s1.params[k]), atol=1e-7,
                err_msg=f"check_vma={cv} leaf={k}",
            )
        np.testing.assert_allclose(
            float(stn.grad_norm), float(st1.grad_norm), rtol=1e-6,
            err_msg=f"check_vma={cv}",
        )


def test_dp_train_step_per_scenario_task(problem):
    """Task randomization: a NON-learnable per-scenario task payload (here a
    per-scenario cost linear term — every scenario pursues its own goal)
    threads through ``step(state, x, u_exp, task)`` and shards with the
    batch via ``task_batch_axes``. A closed-over per-scenario array cannot
    shard under shard_map, so this is the only correct route. Both VMA modes
    must equal the single-device step exactly (f64 branch-stable config)."""
    config, cost, dx, x_init = problem
    T, B = config.T, x_init.shape[0]
    u_expert = jnp.zeros((T, B, 1), x_init.dtype)
    rng = np.random.default_rng(55)
    # per-scenario goal angle -> per-scenario linear cost term (T, B, 4)
    thg = rng.uniform(-0.4, 0.4, B)
    qdiag = jnp.diagonal(cost.C)
    goal = np.stack([np.cos(thg), np.sin(thg), 0 * thg, 0 * thg], -1)
    c_task = jnp.broadcast_to(
        jnp.asarray(-goal * np.asarray(qdiag), x_init.dtype), (T, B, 4)
    )

    def make_problem(params, task):
        return QuadCost(cost.C, task), dx.replace(params=params)

    opt = optax.sgd(1e-2)
    mesh = make_mesh()
    s0 = init_train_state(dx.params, opt)
    step_1 = make_dp_train_step(
        config, make_problem, opt, None, -2.0, 2.0, task_batch_axes=1
    )
    s1, st1 = step_1(s0, x_init, u_expert, c_task)
    # the task must actually matter (distinct goals -> distinct loss vs
    # the shared-goal cost) for the agreement below to mean anything
    st_shared = step_1(
        s0, x_init, u_expert,
        jnp.broadcast_to(cost.c.astype(x_init.dtype), (T, B, 4)),
    )[1]
    assert abs(float(st1.loss) - float(st_shared.loss)) > 1e-8
    for cv in (True, False):
        step_n = make_dp_train_step(
            config, make_problem, opt, mesh, -2.0, 2.0,
            check_vma=cv, task_batch_axes=1,
        )
        sn, stn = step_n(
            s0,
            shard_batch(mesh, x_init, 0),
            shard_batch(mesh, u_expert, 1),
            shard_batch(mesh, c_task, 1),
        )
        np.testing.assert_allclose(
            np.asarray(sn.params), np.asarray(s1.params), atol=1e-7,
            err_msg=f"check_vma={cv}",
        )
        np.testing.assert_allclose(
            float(stn.loss), float(st1.loss), rtol=1e-9,
            err_msg=f"check_vma={cv}",
        )
        np.testing.assert_allclose(
            float(stn.grad_norm), float(st1.grad_norm), rtol=1e-6,
            err_msg=f"check_vma={cv}",
        )


def test_task_batch_axes_rejects_bad_leaves():
    """Task axes leaves must be a non-negative int or None."""
    from diffmpc_tpu.parallel.training import _task_spec

    for bad in (True, -1, {"goal": True}):
        with pytest.raises(ValueError, match="task_batch_axes"):
            _task_spec(bad)


def test_params_batch_axes_rejects_ambiguous_leaves():
    """Axes leaves other than 0/None (e.g. vmap-style booleans) are
    ambiguous — True would be silently REPLICATED (and its scenario
    gradient rows pmean'd across devices); must raise instead."""
    from diffmpc_tpu.parallel.training import _params_spec

    for bad in (True, False, 1, {"dyn": True, "bias": False}):
        with pytest.raises(ValueError, match="params_batch_axes"):
            _params_spec(bad)
