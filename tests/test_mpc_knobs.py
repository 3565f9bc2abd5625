"""Remaining MPC configuration knobs (ref C4 surface): delta_u trust region,
u_init warm start, prev_ctrl, backprop=False, verbose path, FINITE_DIFF."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffmpc_tpu import MPC, MPCConfig, QuadCost, LinDx, mpc_solve
from diffmpc_tpu.models import PendulumDx
from oracles import random_lqr_problem
from test_mpc import swingup_problem


def test_delta_u_trust_region_limits_step():
    """With delta_u, each iteration's controls stay within +-delta_u of the
    previous trajectory's controls; since u starts at 0, after one LQR
    iteration |u| <= delta_u."""
    B, T = 4, 10
    dx, cost, x_init = swingup_problem(B, T, th0_frac=0.6)
    small = 0.05
    ctrl = MPC(
        3, 1, T, u_lower=-2.0, u_upper=2.0, lqr_iter=1, delta_u=small,
        exit_unconverged=False,
    )
    sol = ctrl.solve(x_init, cost, dx)
    assert float(jnp.max(jnp.abs(sol.us))) <= small + 1e-6

    free = MPC(3, 1, T, u_lower=-2.0, u_upper=2.0, lqr_iter=1, exit_unconverged=False)
    sol_free = free.solve(x_init, cost, dx)
    assert float(jnp.max(jnp.abs(sol_free.us))) > small


def test_u_init_warm_start_changes_first_iteration_only():
    """Warm start must be respected (initial trajectory rolls u_init) and a
    good warm start must not hurt the final objective."""
    B, T = 4, 15
    dx, cost, x_init = swingup_problem(B, T, th0_frac=0.6)
    cold = MPC(3, 1, T, u_lower=-2.0, u_upper=2.0, lqr_iter=20, exit_unconverged=False)
    sol_cold = cold.solve(x_init, cost, dx)
    warm = MPC(
        3, 1, T, u_lower=-2.0, u_upper=2.0, lqr_iter=20, exit_unconverged=False,
        u_init=sol_cold.us,
    )
    sol_warm = warm.solve(x_init, cost, dx)
    assert bool(jnp.all(sol_warm.objs <= sol_cold.objs + 1e-5))
    # warm start converges immediately
    assert int(sol_warm.info.n_iters) <= int(sol_cold.info.n_iters)


def test_prev_ctrl_enters_slew_formulation():
    """prev_ctrl anchors the slew penalty at t=0: a large prev control pulls
    the first control toward it compared to prev_ctrl=0."""
    B, T = 4, 10
    dx, cost, x_init = swingup_problem(B, T, th0_frac=0.6)
    base = MPC(
        3, 1, T, u_lower=-2.0, u_upper=2.0, lqr_iter=15, exit_unconverged=False,
        slew_rate_penalty=10.0,
    )
    anchored = MPC(
        3, 1, T, u_lower=-2.0, u_upper=2.0, lqr_iter=15, exit_unconverged=False,
        slew_rate_penalty=10.0, prev_ctrl=jnp.full((B, 1), 2.0, x_init.dtype),
    )
    u0_base = base.solve(x_init, cost, dx).us[0]
    u0_anch = anchored.solve(x_init, cost, dx).us[0]
    assert float(jnp.mean(u0_anch)) > float(jnp.mean(u0_base))


def test_backprop_false_blocks_gradients():
    B, T = 3, 8
    dx, cost, x_init = swingup_problem(B, T, th0_frac=0.7)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=5, exit_unconverged=False,
        backprop=False, dtype=jnp.float64,
    )

    def loss(params):
        sol = mpc_solve(
            config, x_init, cost, dx.replace(params=params),
            u_lower=-2.0, u_upper=2.0,
        )
        return jnp.sum(sol.us**2)

    g = jax.grad(loss)(dx.params)
    np.testing.assert_allclose(np.asarray(g), 0.0)


def test_verbose_solve_runs():
    rng = np.random.default_rng(500)
    T, B, n, m = 4, 2, 3, 2
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    ctrl = MPC(n, m, T, lqr_iter=2, verbose=1, exit_unconverged=False)
    ctrl(jnp.asarray(x_init), QuadCost(C, c), LinDx(F, f))  # must not raise


def test_solution_info_stats_populated():
    B, T = 4, 10
    dx, cost, x_init = swingup_problem(B, T, th0_frac=0.6)
    ctrl = MPC(3, 1, T, u_lower=-0.5, u_upper=0.5, lqr_iter=10, exit_unconverged=False)
    sol = ctrl.solve(x_init, cost, dx)
    info = sol.info
    assert info.converged.shape == (B,)
    assert float(jnp.max(info.clamp_frac)) > 0  # tight bounds must clamp
    assert bool(jnp.all(info.mean_alpha > 0))
    assert int(info.n_iters) >= 1


def test_u_zero_I_pins_control_dims():
    """Reference knob: control dims masked by u_zero_I stay exactly zero
    and carry no gradient influence (tight-dim freezing in the backward)."""
    rng = np.random.default_rng(600)
    T, B, n, m = 8, 6, 3, 2
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    mask = np.zeros((T, B, m), bool)
    mask[:, :, 1] = True  # second control dim always pinned

    ctrl = MPC(n, m, T, lqr_iter=5, exit_unconverged=False, u_zero_I=jnp.asarray(mask))
    xs, us, objs = ctrl(jnp.asarray(x_init), QuadCost(C, c), LinDx(F, f))
    np.testing.assert_allclose(np.asarray(us[:, :, 1]), 0.0, atol=1e-12)
    assert float(jnp.max(jnp.abs(us[:, :, 0]))) > 0

    # equivalent to solving the m=1 problem with dim-1 columns removed
    keep = [0, 1, 2, 3]  # x dims + first control
    C1 = C[..., keep, :][..., :, keep]
    c1 = c[..., keep]
    F1 = F[..., :, keep]
    ctrl1 = MPC(n, 1, T, lqr_iter=5, exit_unconverged=False)
    _, us1, _ = ctrl1(jnp.asarray(x_init), QuadCost(C1, c1), LinDx(F1, f))
    np.testing.assert_allclose(np.asarray(us[:, :, :1]), np.asarray(us1), atol=1e-5)


def test_u_zero_I_composes_with_slew_penalty():
    """u_zero_I must be forwarded into the slew-augmented solve —
    pinned control dims stay zero when slew_rate_penalty is also set."""
    rng = np.random.default_rng(601)
    T, B, n, m = 8, 4, 3, 2
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    mask = np.zeros((T, B, m), bool)
    mask[:, :, 1] = True

    ctrl = MPC(
        n, m, T, lqr_iter=5, exit_unconverged=False,
        slew_rate_penalty=1.0, u_zero_I=jnp.asarray(mask),
    )
    xs, us, objs = ctrl(jnp.asarray(x_init), QuadCost(C, c), LinDx(F, f))
    np.testing.assert_allclose(np.asarray(us[:, :, 1]), 0.0, atol=1e-12)
    assert float(jnp.max(jnp.abs(us[:, :, 0]))) > 0
    assert xs.shape == (T, B, n)  # augmented state dims stripped


def test_bound_shape_validation():
    """2-D bounds are (T, m) only; a (B, m) bound raises instead of being
    silently misread."""
    B, T = 4, 10
    dx, cost, x_init = swingup_problem(B, T, th0_frac=0.6)
    config = MPCConfig(n_state=3, n_ctrl=1, T=T, exit_unconverged=False)
    bad = jnp.full((B, 1), -2.0)  # (B, m) with B != T
    with pytest.raises(ValueError, match=r"\(T="):
        mpc_solve(config, x_init, cost, dx, u_lower=bad, u_upper=-bad)
    with pytest.raises(ValueError, match="1-D"):
        mpc_solve(
            config, x_init, cost, dx,
            u_lower=jnp.full((3,), -2.0), u_upper=jnp.full((3,), 2.0),
        )
    # the valid (T, m) form still works
    sol = mpc_solve(
        config, x_init, cost, dx,
        u_lower=jnp.full((T, 1), -2.0), u_upper=jnp.full((T, 1), 2.0),
    )
    assert sol.us.shape == (T, B, 1)
    # a (1,) bound broadcasts like a scalar for any n_ctrl (pre-validation
    # behavior; regression caught by self-review round 2)
    sol1 = mpc_solve(
        config, x_init, cost, dx,
        u_lower=jnp.asarray([-2.0]), u_upper=jnp.asarray([2.0]),
    )
    np.testing.assert_array_equal(np.asarray(sol1.us), np.asarray(sol.us))


def test_nonsymmetric_cost_canonicalized():
    """A non-symmetric QuadCost.C is symmetrized on entry, so it solves the
    same problem as its symmetric part."""
    rng = np.random.default_rng(602)
    T, B, n, m = 6, 3, 3, 2
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    skew = jnp.asarray(rng.normal(size=C.shape) * 0.1)
    C_asym = C + (skew - jnp.swapaxes(skew, -1, -2))  # same symmetric part
    ctrl = MPC(n, m, T, lqr_iter=4, exit_unconverged=False)
    _, us_sym, _ = ctrl(jnp.asarray(x_init), QuadCost(C, c), LinDx(F, f))
    _, us_asym, _ = ctrl(jnp.asarray(x_init), QuadCost(C_asym, c), LinDx(F, f))
    np.testing.assert_allclose(np.asarray(us_asym), np.asarray(us_sym), atol=1e-6)


def test_bench_convergence_is_iteration_budget_bound():
    """the headline benchmark's converged_frac
    (~0.68 at lqr_iter=10) is a property of the iteration budget on the
    chaotic swing-up distribution — the reference-equivalent XLA path shows
    the same fraction, and raising the budget (the user-facing fix) raises
    convergence. 'solves/s' at fixed lqr_iter is therefore honest
    fixed-work throughput, not masked failure."""
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from __graft_entry__ import _pendulum_setup, _x_init
    import dataclasses

    B = 256  # scaled-down bench batch; same distribution/seed family
    config, cost, dx = _pendulum_setup(T=20)
    config = dataclasses.replace(config, use_pallas=False)
    x0 = _x_init(B, seed=0)

    sol10 = jax.jit(
        lambda x: mpc_solve(config, x, cost, dx, u_lower=-2.0, u_upper=2.0)
    )(x0)
    frac10 = float(jnp.mean(sol10.info.converged))
    assert 0.5 < frac10 < 0.85, frac10  # the ~0.68 bench regime

    config40 = dataclasses.replace(config, lqr_iter=40)
    sol40 = jax.jit(
        lambda x: mpc_solve(config40, x, cost, dx, u_lower=-2.0, u_upper=2.0)
    )(x0)
    frac40 = float(jnp.mean(sol40.info.converged))
    assert frac40 > frac10 + 0.1, (frac10, frac40)
    # more iterations never worsen the best-tracked objective
    assert bool(jnp.all(sol40.objs <= sol10.objs + 1e-4))


@pytest.mark.parametrize("seed", range(12))
def test_knob_combination_fuzz(seed):
    """Random KNOB COMBINATIONS (the axis the named tests don't cover:
    interactions). Each seed draws a random subset of {bounds, u_init,
    delta_u, slew_rate_penalty+prev_ctrl, u_zero_I, per-scenario params,
    detach_unconverged, best_cost_eps} and asserts the invariants every
    combination must satisfy: bounds respected, pinned dims zero, the
    lqr_iter=1 trust region honored, stats sane, and (when differentiable)
    finite gradients through the composed solve."""
    import dataclasses

    rng = np.random.default_rng(7100 + seed)
    B, T, n, m = 6, 5, 3, 1
    dx = PendulumDx.default(jnp.float32)
    use_bounds = bool(rng.integers(0, 2))
    use_warm = bool(rng.integers(0, 2))
    use_delta = bool(rng.integers(0, 2))
    use_slew = bool(rng.integers(0, 2))
    use_zero = bool(rng.integers(0, 2)) and use_bounds  # u_zero_I needs box
    use_bparams = bool(rng.integers(0, 2))
    if use_bparams:
        scale = jnp.asarray(
            rng.uniform(0.9, 1.1, (B, 3)).astype(np.float32)
        )
        dx = dx.replace(params=jnp.asarray(dx.params) * scale)

    q, p = PendulumDx.default(jnp.float32).get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    config = MPCConfig(
        n_state=n, n_ctrl=m, T=T,
        lqr_iter=1 if use_delta else int(rng.integers(2, 5)),
        eps=1e-5,
        delta_u=0.3 if use_delta else None,
        slew_rate_penalty=float(rng.uniform(1e-3, 1e-1)) if use_slew else None,
        best_cost_eps=float(rng.choice([1e-4, 1e-2])),
        not_improved_lim=int(rng.integers(2, 6)),
        exit_unconverged=False,
        detach_unconverged=bool(rng.integers(0, 2)),
        dtype=jnp.float32,
    )
    th = rng.uniform(-np.pi, np.pi, B)
    x = jnp.asarray(
        np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1),
        jnp.float32,
    )
    bound = float(rng.uniform(0.5, 2.0))
    lo, hi = (-bound, bound) if use_bounds else (None, None)
    u_init = (
        jnp.asarray(rng.uniform(-0.3, 0.3, (T, B, m)), jnp.float32)
        if use_warm else None
    )
    u_zero_I = None
    if use_zero:
        u_zero_I = jnp.zeros((T, B, m), bool).at[T // 2].set(True)
    prev = (
        jnp.asarray(rng.uniform(-0.5, 0.5, (B, m)), jnp.float32)
        if use_slew else None
    )

    sol = jax.jit(
        lambda xi: mpc_solve(
            config, xi, cost, dx, u_init=u_init, u_lower=lo, u_upper=hi,
            prev_ctrl=prev, u_zero_I=u_zero_I,
        )
    )(x)

    assert bool(jnp.all(jnp.isfinite(sol.xs)))
    assert bool(jnp.all(jnp.isfinite(sol.us)))
    assert bool(jnp.all(jnp.isfinite(sol.objs)))
    if use_bounds:
        assert bool(jnp.all(sol.us >= lo - 1e-6))
        assert bool(jnp.all(sol.us <= hi + 1e-6))
    if use_zero:
        assert float(jnp.max(jnp.abs(sol.us[T // 2]))) <= 1e-6
    if use_delta:
        base = u_init if u_init is not None else jnp.zeros_like(sol.us)
        assert float(jnp.max(jnp.abs(sol.us - base))) <= 0.3 + 1e-5
    info = sol.info
    assert int(info.n_iters) <= config.lqr_iter
    assert bool(jnp.all((info.clamp_frac >= 0) & (info.clamp_frac <= 1)))
    assert bool(jnp.all(info.mean_alpha <= 1.0 + 1e-6))
    assert bool(jnp.all(info.qp_iters >= 0))

    # every combination must stay differentiable (x_init + params)
    def loss(xi, params):
        d = dx.replace(params=params)
        s = mpc_solve(
            config, xi, cost, d, u_init=u_init, u_lower=lo, u_upper=hi,
            prev_ctrl=prev, u_zero_I=u_zero_I,
        )
        return jnp.sum(s.us ** 2) + jnp.sum(s.objs)

    gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(x, jnp.asarray(dx.params))
    assert bool(jnp.all(jnp.isfinite(gx)))
    assert bool(jnp.all(jnp.isfinite(gp)))
