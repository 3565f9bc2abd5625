"""Per-scenario (domain-randomized) dynamics parameters.

Beyond the reference surface: the reference's env params are module-level
scalars shared by the whole batch ([RECALL: mpc/env_dx/pendulum.py params]);
here ``params`` may carry a leading scenario axis ``(B, P)`` so every
scenario solves under its own physics, on both the XLA path and the fused
Pallas kernels (params staged as one vector per program tile), with per-scenario
gradients through the analytic KKT backward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffmpc_tpu import MPCConfig, QuadCost, mpc_solve
from diffmpc_tpu.models import CartpoleDx, PendulumDx
from diffmpc_tpu.mpc import _would_use_fused


def _problem(B, T):
    dx = PendulumDx.default(jnp.float32)
    q, p = dx.get_true_obj()
    rng = np.random.default_rng(42)
    th = rng.uniform(-np.pi, np.pi, B)
    x_init = jnp.asarray(
        np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1),
        jnp.float32,
    )
    return dx, QuadCost(jnp.diag(q), p), x_init


def _two_group_params(dx, B):
    """(B, 3): first half true params, second half a heavier/longer pendulum."""
    alt = dx.params * jnp.asarray([1.0, 1.3, 0.8], dx.params.dtype)
    return jnp.concatenate(
        [jnp.broadcast_to(dx.params, (B // 2, 3)),
         jnp.broadcast_to(alt, (B - B // 2, 3))],
        axis=0,
    ), alt


def test_xla_path_matches_per_group_solves():
    B, T = 8, 10
    dx, cost, x_init = _problem(B, T)
    params_b, alt = _two_group_params(dx, B)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=6,
        exit_unconverged=False, detach_unconverged=False, use_pallas=False,
    )

    sol = mpc_solve(
        config, x_init, cost, dx.replace(params=params_b),
        u_lower=-2.0, u_upper=2.0,
    )
    lo = mpc_solve(
        config, x_init[: B // 2], cost, dx, u_lower=-2.0, u_upper=2.0
    )
    hi = mpc_solve(
        config, x_init[B // 2 :], cost, dx.replace(params=alt),
        u_lower=-2.0, u_upper=2.0,
    )
    ref_us = jnp.concatenate([lo.us, hi.us], axis=1)
    np.testing.assert_allclose(
        np.asarray(sol.us), np.asarray(ref_us), atol=1e-5
    )
    # the two groups genuinely solve different physics
    assert float(jnp.max(jnp.abs(lo.us - hi.us))) > 1e-3


def test_per_scenario_gradients_match_group_grads():
    B, T = 6, 8
    dx, cost, x_init = _problem(B, T)
    params_b, alt = _two_group_params(dx, B)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=4,
        exit_unconverged=False, detach_unconverged=False, use_pallas=False,
    )

    def loss_batched(p):
        sol = mpc_solve(
            config, x_init, cost, dx.replace(params=p),
            u_lower=-2.0, u_upper=2.0,
        )
        return jnp.sum(sol.us**2)

    g = jax.jit(jax.grad(loss_batched))(params_b)
    assert g.shape == (B, 3)

    def loss_group(p, x):
        sol = mpc_solve(
            config, x, cost, dx.replace(params=p), u_lower=-2.0, u_upper=2.0
        )
        return jnp.sum(sol.us**2)

    g_lo = jax.jit(jax.grad(loss_group))(dx.params, x_init[: B // 2])
    g_hi = jax.jit(jax.grad(loss_group))(alt, x_init[B // 2 :])
    np.testing.assert_allclose(
        np.asarray(jnp.sum(g[: B // 2], axis=0)), np.asarray(g_lo),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(jnp.sum(g[B // 2 :], axis=0)), np.asarray(g_hi),
        rtol=1e-4, atol=1e-5,
    )


def test_fused_kernel_batched_params_matches_xla():
    # B=512: several program tiles with per-scenario params each.
    B, T = 512, 8
    dx, cost, x_init = _problem(B, T)
    params_b, _ = _two_group_params(dx, B)
    base = dict(
        n_state=3, n_ctrl=1, T=T, lqr_iter=4, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False,
    )
    config_x = MPCConfig(**base, use_pallas=False)
    config_p = MPCConfig(**base, use_pallas=True, pallas_interpret=True)
    dxb = dx.replace(params=params_b)
    from diffmpc_tpu.mpc import _would_use_fused

    assert _would_use_fused(
        config_p, dxb, is_quad=True, constrained=True, is_lin=False
    )

    ref = jax.jit(
        lambda x: mpc_solve(config_x, x, cost, dxb, u_lower=-2.0, u_upper=2.0)
    )(x_init)
    out = jax.jit(
        lambda x: mpc_solve(config_p, x, cost, dxb, u_lower=-2.0, u_upper=2.0)
    )(x_init)
    # chaos tolerance over multiple iLQR iterations, as in test_pallas_ilqr
    np.testing.assert_allclose(
        np.asarray(out.objs), np.asarray(ref.objs), rtol=5e-3, atol=5e-3
    )
    close = np.abs(np.asarray(out.us) - np.asarray(ref.us)) < 1e-2
    assert close.mean() > 0.95, close.mean()


def test_fused_kernel_batched_params_gradients():
    B, T = 512, 8
    dx, cost, x_init = _problem(B, T)
    params_b, _ = _two_group_params(dx, B)
    config_p = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=3, exit_unconverged=False,
        detach_unconverged=False, use_pallas=True, pallas_interpret=True,
    )
    from diffmpc_tpu.mpc import _would_use_fused

    assert _would_use_fused(
        config_p, dx.replace(params=params_b),
        is_quad=True, constrained=True, is_lin=False,
    )
    config_x = dataclasses.replace(
        config_p, use_pallas=False, pallas_interpret=False
    )

    def loss(p, config):
        sol = mpc_solve(
            config, x_init, cost, dx.replace(params=p),
            u_lower=-2.0, u_upper=2.0,
        )
        return jnp.sum(sol.us**2)

    g_p = jax.jit(jax.grad(lambda p: loss(p, config_p)))(params_b)
    g_x = jax.jit(jax.grad(lambda p: loss(p, config_x)))(params_b)
    assert g_p.shape == (B, 3)
    assert bool(jnp.all(jnp.isfinite(g_p)))
    # The analytic KKT backward is a function of the final fixed point, so
    # the honest claim is conditional: on scenarios where both paths settle
    # at the same local solution (chaotic swing-up diverges on the rest),
    # the per-scenario gradient rows must agree essentially exactly.
    def us_of(p, config):
        return mpc_solve(
            config, x_init, cost, dx.replace(params=p),
            u_lower=-2.0, u_upper=2.0,
        ).us

    u_p = jax.jit(lambda p: us_of(p, config_p))(params_b)
    u_x = jax.jit(lambda p: us_of(p, config_x))(params_b)
    same = np.abs(np.asarray(u_p - u_x)).max(axis=(0, 2)) < 1e-3  # (B,)
    assert same.mean() > 0.5, same.mean()
    close = np.isclose(np.asarray(g_p), np.asarray(g_x), rtol=5e-2, atol=5e-3)
    assert close[same].mean() > 0.99, close[same].mean()


def test_cartpole_autodiff_grad_input_batched():
    """The Dynamics base grad_input (no closed form on cartpole) must map
    jacfwd jointly over (params, x, u) instead of closing over batched
    params."""
    B, T = 5, 3
    cp = CartpoleDx.default(jnp.float32)
    rng = np.random.default_rng(7)
    params_b = jnp.asarray(
        np.asarray(cp.params) * rng.uniform(0.8, 1.2, (B, 4)), jnp.float32
    )
    x = jnp.asarray(rng.normal(size=(T, B, 5)), jnp.float32)
    u = jnp.asarray(rng.normal(size=(T, B, 1)), jnp.float32)

    A, Bm = cp.replace(params=params_b).grad_input(x, u)
    assert A.shape == (T, B, 5, 5) and Bm.shape == (T, B, 5, 1)
    for b in (0, B - 1):
        A1, B1 = cp.replace(params=params_b[b]).grad_input(x[:, b], u[:, b])
        np.testing.assert_allclose(np.asarray(A[:, b]), np.asarray(A1), atol=1e-5)
        np.testing.assert_allclose(np.asarray(Bm[:, b]), np.asarray(B1), atol=1e-5)


def test_batched_params_wrong_batch_raises():
    B, T = 8, 6
    dx, cost, x_init = _problem(B, T)
    config = MPCConfig(n_state=3, n_ctrl=1, T=T, exit_unconverged=False)
    bad = jnp.broadcast_to(dx.params, (B + 1, 3))
    with pytest.raises(ValueError, match="per-scenario"):
        mpc_solve(
            config, x_init, cost, dx.replace(params=bad),
            u_lower=-2.0, u_upper=2.0,
        )


def test_per_scenario_sysid_improves():
    """End-to-end domain-randomized sysid (examples/sysid_domain_rand.py in
    miniature): every scenario has its own true physics; training a (B, 3)
    params array through the KKT backward halves the imitation loss and
    reduces the mean per-scenario parameter error."""
    import optax

    from diffmpc_tpu.parallel import (
        generate_expert_data,
        init_train_state,
        make_dp_train_step,
    )

    dtype = jnp.float32
    B, K, T = 4, 8, 10  # scenarios, trajectories per scenario, horizon
    nominal = PendulumDx.default(dtype)
    q, p = nominal.get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=5, eps=1e-5,
        exit_unconverged=False, detach_unconverged=True, dtype=dtype,
    )
    rng = np.random.default_rng(1)
    true_params = jnp.asarray(
        np.asarray(nominal.params) * rng.uniform(0.8, 1.2, (B, 3)), dtype
    )
    th = rng.uniform(-np.pi, np.pi, B * K)
    x_init = jnp.asarray(
        np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B * K)], -1),
        dtype,
    )
    _, u_expert, _ = jax.jit(
        lambda pp, x: generate_expert_data(
            config, cost, nominal.replace(params=jnp.repeat(pp, K, axis=0)),
            x, -2.0, 2.0,
        )
    )(true_params, x_init)

    params0 = jnp.broadcast_to(
        jnp.asarray(np.asarray(nominal.params) * rng.uniform(0.8, 1.2, 3), dtype),
        (B, 3),
    )

    def make_problem(params):
        return cost, nominal.replace(params=jnp.repeat(params, K, axis=0))

    optimizer = optax.adam(1e-2)
    step = make_dp_train_step(
        config, make_problem, optimizer, mesh=None,
        u_lower=-2.0, u_upper=2.0,
    )
    state = init_train_state(params0, optimizer)

    def err(params):
        return float(jnp.mean(jnp.abs(params - true_params) / true_params))

    losses = []
    for _ in range(40):
        state, stats = step(state, x_init, u_expert)
        losses.append(float(stats.loss))
    assert losses[-1] < 0.6 * losses[0], losses[::10]
    assert err(state.params) < err(params0), (err(params0), err(state.params))


def test_cartpole_fused_batched_params_matches_xla():
    """Per-scenario params on the SECOND env family (n=5 cartpole — its
    entries_step linearizes via in-kernel jvp, so the per-scenario params
    must broadcast through that too)."""
    B, T = 512, 8
    cp = CartpoleDx.default(jnp.float32)
    qc, pc = cp.get_true_obj()
    cost = QuadCost(jnp.diag(qc), pc)
    rng = np.random.default_rng(9)
    params_b = jnp.asarray(
        np.asarray(cp.params) * rng.uniform(0.85, 1.15, (B, 4)), jnp.float32
    )
    th = rng.uniform(-0.3, 0.3, B)
    x = jnp.asarray(
        np.stack([rng.uniform(-0.5, 0.5, B), 0 * th, np.cos(th), np.sin(th),
                  rng.uniform(-0.5, 0.5, B)], -1), jnp.float32)
    base = dict(
        n_state=5, n_ctrl=1, T=T, lqr_iter=4, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False,
    )
    config_x = MPCConfig(**base, use_pallas=False)
    config_p = MPCConfig(**base, use_pallas=True, pallas_interpret=True)
    cpb = cp.replace(params=params_b)
    from diffmpc_tpu.mpc import _would_use_fused

    assert _would_use_fused(
        config_p, cpb, is_quad=True, constrained=True, is_lin=False
    )

    ref = jax.jit(
        lambda xx: mpc_solve(config_x, xx, cost, cpb, u_lower=-10.0, u_upper=10.0)
    )(x)
    out = jax.jit(
        lambda xx: mpc_solve(config_p, xx, cost, cpb, u_lower=-10.0, u_upper=10.0)
    )(x)
    np.testing.assert_allclose(
        np.asarray(out.objs), np.asarray(ref.objs), rtol=5e-3, atol=5e-3
    )
    close = np.abs(np.asarray(out.us) - np.asarray(ref.us)) < 1e-2
    assert close.mean() > 0.95, close.mean()


def test_long_horizon_batched_params_fused_matches_xla():
    """Per-scenario params through the mega-kernel at a long horizon:
    exercises the per-scenario parameter vectors (one per program tile)
    across many in-kernel steps, pinned against the XLA orchestration at
    a single iLQR step in interpret mode."""
    T, B = 48, 40
    dx, cost, x_init = _problem(B, T)
    params_b, _ = _two_group_params(dx, B)
    dxb = dx.replace(params=params_b)
    kw = dict(
        n_state=3, n_ctrl=1, T=T, lqr_iter=1, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False,
    )
    config_p = MPCConfig(**kw, use_pallas=True, pallas_interpret=True)
    config_x = MPCConfig(**kw, use_pallas=False)
    assert _would_use_fused(
        config_p, dxb, is_quad=True, constrained=True, is_lin=False
    )

    def run(cfg):
        return jax.jit(
            lambda x: mpc_solve(cfg, x, cost, dxb, u_lower=-2.0, u_upper=2.0)
        )(x_init)

    out, ref = run(config_p), run(config_x)
    np.testing.assert_allclose(np.asarray(out.us), np.asarray(ref.us), atol=5e-4)
    np.testing.assert_allclose(
        np.asarray(out.objs), np.asarray(ref.objs), rtol=5e-4, atol=5e-4
    )
def test_autodiff_grad_method_batched_params():
    """GradMethods.AUTO_DIFF must route through the batched-aware jacfwd
    (closing over (B, P) params inside the per-sample vmap broadcasts wrong
    shapes — code-review regression)."""
    from diffmpc_tpu.ops.linearize import linearize_dynamics
    from diffmpc_tpu.types import GradMethods

    B, T = 4, 5
    dx, cost, x_init = _problem(B, T)
    params_b, _ = _two_group_params(dx, B)
    dxb = dx.replace(params=params_b)
    xs = jnp.broadcast_to(x_init, (T, B, 3))
    us = jnp.zeros((T, B, 1), jnp.float32)
    lin_ad = linearize_dynamics(dxb, xs, us, method=GradMethods.AUTO_DIFF)
    lin_an = linearize_dynamics(dxb, xs, us, method=GradMethods.ANALYTIC)
    np.testing.assert_allclose(
        np.asarray(lin_ad.F), np.asarray(lin_an.F), rtol=1e-4, atol=1e-5
    )

    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=3, grad_method=GradMethods.AUTO_DIFF,
        exit_unconverged=False, detach_unconverged=False, use_pallas=False,
    )
    sol = mpc_solve(config, x_init, cost, dxb, u_lower=-2.0, u_upper=2.0)
    assert bool(jnp.all(jnp.isfinite(sol.us)))


def test_slew_rate_batched_params_validated_and_solves():
    """The slew-augmented recursion wraps dx in CtrlPassthroughDynamics —
    the per-scenario shape check must still fire before it (code-review
    regression), and a correctly-shaped solve must work."""
    B, T = 8, 6
    dx, cost, x_init = _problem(B, T)
    params_b, _ = _two_group_params(dx, B)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=3, slew_rate_penalty=0.1,
        exit_unconverged=False, detach_unconverged=False, use_pallas=False,
    )
    bad = jnp.broadcast_to(dx.params, (B + 1, 3))
    with pytest.raises(ValueError, match="per-scenario"):
        mpc_solve(
            config, x_init, cost, dx.replace(params=bad),
            u_lower=-2.0, u_upper=2.0,
        )
    sol = mpc_solve(
        config, x_init, cost, dx.replace(params=params_b),
        u_lower=-2.0, u_upper=2.0,
    )
    assert bool(jnp.all(jnp.isfinite(sol.us)))


def test_per_scenario_cost_matches_per_group_solves():
    """Task randomization (the cost-side analog of per-scenario dynamics):
    QuadCost accepts full (T, B, nm, nm)/(T, B, nm) arrays per the
    reference's shape contract, so every scenario can solve its own
    objective, with per-scenario cost gradients through the KKT backward."""
    B, T = 8, 10
    dx, cost, x_init = _problem(B, T)
    nm = 4
    w_hi = jnp.asarray([1.0, 1.0, 0.5, 0.01], jnp.float32)
    w_lo = jnp.asarray([0.2, 0.2, 0.1, 0.05], jnp.float32)
    C_b = jnp.concatenate(
        [
            jnp.broadcast_to(jnp.diag(w_lo), (T, B // 2, nm, nm)),
            jnp.broadcast_to(jnp.diag(w_hi), (T, B - B // 2, nm, nm)),
        ],
        axis=1,
    )
    c_b = jnp.broadcast_to(cost.c, (T, B, nm))
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=6,
        exit_unconverged=False, detach_unconverged=False, use_pallas=False,
    )
    sol = mpc_solve(
        config, x_init, QuadCost(C_b, c_b), dx, u_lower=-2.0, u_upper=2.0
    )
    lo = mpc_solve(
        config, x_init[: B // 2], QuadCost(jnp.diag(w_lo), cost.c), dx,
        u_lower=-2.0, u_upper=2.0,
    )
    hi = mpc_solve(
        config, x_init[B // 2 :], QuadCost(jnp.diag(w_hi), cost.c), dx,
        u_lower=-2.0, u_upper=2.0,
    )
    ref_us = jnp.concatenate([lo.us, hi.us], axis=1)
    np.testing.assert_allclose(np.asarray(sol.us), np.asarray(ref_us), atol=1e-5)

    # per-scenario cost gradients: dloss/dC has the full (T, B, nm, nm)
    # shape and scenario rows are independent
    g = jax.jit(
        jax.grad(
            lambda C: jnp.sum(
                mpc_solve(
                    config, x_init, QuadCost(C, c_b), dx,
                    u_lower=-2.0, u_upper=2.0,
                ).us ** 2
            )
        )
    )(C_b)
    assert g.shape == (T, B, nm, nm)
    assert bool(jnp.all(jnp.isfinite(g)))
