"""Planar quadrotor env (n=6, m=2): beyond the reference's env zoo —
exercises the m>1 box-DDP machinery (in-kernel m=2 pnqp, asymmetric
0 <= u <= max box, nonzero-setpoint control cost) on real dynamics."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from diffmpc_tpu import MPCConfig, QuadCost, mpc_solve
from diffmpc_tpu.models import QuadrotorDx


def _x_init(B, seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        np.stack(
            [
                rng.uniform(-scale, scale, B),        # px
                rng.uniform(-scale, scale, B),        # pz
                rng.uniform(-0.3, 0.3, B),            # phi
                rng.uniform(-0.3, 0.3, B),            # vx
                rng.uniform(-0.3, 0.3, B),            # vz
                rng.uniform(-0.3, 0.3, B),            # om
            ],
            -1,
        ),
        jnp.float32,
    )


def _setup(T, B, lqr_iter=10, **kw):
    dx = QuadrotorDx.default(jnp.float32)
    q, p = dx.get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    kw.setdefault("eps", 1e-5)
    config = MPCConfig(
        n_state=6, n_ctrl=2, T=T, lqr_iter=lqr_iter,
        exit_unconverged=False, detach_unconverged=False, **kw,
    )
    return dx, cost, config


def test_hover_is_equilibrium():
    dx = QuadrotorDx.default(jnp.float32)
    x0 = jnp.zeros((4, 6), jnp.float32)
    uh = jnp.broadcast_to(dx.hover_thrust(), (4, 2)).astype(jnp.float32)
    x1 = dx.forward(x0, uh)
    np.testing.assert_allclose(np.asarray(x1), 0.0, atol=1e-6)


def test_entries_step_matches_forward():
    dx = QuadrotorDx.default(jnp.float32)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(32, 6)), jnp.float32)
    u = jnp.asarray(rng.uniform(0, 5, (32, 2)), jnp.float32)
    ref = dx.forward(x, u)
    out = dx.entries_step(
        [dx.params[i] for i in range(4)],
        [x[:, i] for i in range(6)],
        [u[:, i] for i in range(2)],
    )
    np.testing.assert_allclose(
        np.asarray(jnp.stack(out, -1)), np.asarray(ref), atol=1e-6
    )


def test_mpc_stabilizes_to_hover():
    # 2s horizon: T=25 plans too short to bring position back within the
    # plan; T=40 reaches err ratio ~0.25 (probed on CPU)
    B, T = 16, 40
    dx, cost, config = _setup(T, B, lqr_iter=15)
    x0 = _x_init(B)
    sol = jax.jit(
        lambda x: mpc_solve(config, x, cost, dx, u_lower=0.0, u_upper=dx.max_thrust)
    )(x0)
    assert bool(jnp.all(jnp.isfinite(sol.us)))
    # thrusts respect the asymmetric box
    assert float(jnp.min(sol.us)) >= -1e-5
    assert float(jnp.max(sol.us)) <= dx.max_thrust + 1e-5
    # terminal state much closer to hover than the start
    err0 = jnp.linalg.norm(sol.xs[0], axis=-1)
    errT = jnp.linalg.norm(sol.xs[-1], axis=-1)
    assert float(jnp.mean(errT)) < 0.35 * float(jnp.mean(err0)), (
        float(jnp.mean(err0)), float(jnp.mean(errT)))
    # terminal controls near hover thrust
    uh = float(dx.hover_thrust())
    assert abs(float(jnp.mean(sol.us[-1])) - uh) < 0.3 * uh


def test_fused_kernel_matches_xla():
    """m=2 in-kernel pnqp on a real nonlinear model (interpret mode)."""
    B, T = 512, 8
    dx, cost, config = _setup(T, B, lqr_iter=4, eps=0.0, not_improved_lim=10**6)
    config_x = dataclasses.replace(config, use_pallas=False)
    config_p = dataclasses.replace(config, use_pallas=True, pallas_interpret=True)
    x0 = _x_init(B)
    from diffmpc_tpu.mpc import _would_use_fused

    assert _would_use_fused(
        config_p, dx, is_quad=True, constrained=True, is_lin=False
    )
    ref = jax.jit(
        lambda x: mpc_solve(config_x, x, cost, dx, u_lower=0.0, u_upper=5.0)
    )(x0)
    out = jax.jit(
        lambda x: mpc_solve(config_p, x, cost, dx, u_lower=0.0, u_upper=5.0)
    )(x0)
    np.testing.assert_allclose(
        np.asarray(out.objs), np.asarray(ref.objs), rtol=5e-3, atol=5e-3
    )
    close = np.abs(np.asarray(out.us) - np.asarray(ref.us)) < 1e-2
    assert close.mean() > 0.95, close.mean()


def test_qp_iters_semantics_agree_across_paths(monkeypatch):
    """MPCInfo.qp_iters means ONE thing on every dispatch —
    inner-QP solve count: exactly 1 for direct exact solves (the m<=2
    enumeration/closed form, default on BOTH paths since round 4), true
    Newton-iteration counts when the iterative loop dispatches (enum knob
    off). Pinned here at m=2 where round 3 had let the paths diverge."""
    from diffmpc_tpu.ops.pallas import riccati as R

    B, T = 256, 6
    dx, cost, config = _setup(T, B, lqr_iter=2, eps=0.0, not_improved_lim=10**6)
    config_x = dataclasses.replace(config, use_pallas=False)
    config_p = dataclasses.replace(config, use_pallas=True, pallas_interpret=True)
    x0 = _x_init(B)

    def qp_of(cfg):
        sol = mpc_solve(cfg, x0, cost, dx, u_lower=0.0, u_upper=5.0)
        return np.asarray(sol.info.qp_iters)

    # default (enumeration): both paths report exactly 1.0 — direct solves
    for cfg in (config_x, config_p):
        qp = qp_of(cfg)
        np.testing.assert_allclose(qp, 1.0, atol=1e-6)

    # iterative loop forced on both paths: true counts, >= 1, and some
    # scenario takes more than one Newton iteration somewhere
    monkeypatch.setattr(R, "_PNQP_ENUM", "0")
    for cfg in (config_x, config_p):
        qp = qp_of(cfg)
        assert (qp >= 1.0 - 1e-6).all()
        assert (qp > 1.0 + 1e-6).any(), "loop never iterated — bad fixture"


def test_sysid_gradients_flow():
    B, T = 8, 10
    dx, cost, config = _setup(T, B, lqr_iter=4)

    def loss(params):
        sol = mpc_solve(
            config, _x_init(B, seed=5), cost, dx.replace(params=params),
            u_lower=0.0, u_upper=5.0,
        )
        return jnp.mean(sol.us**2)

    g = jax.jit(jax.grad(loss))(dx.params)
    assert g.shape == (4,)
    assert bool(jnp.all(jnp.isfinite(g)))
    assert float(jnp.linalg.norm(g)) > 1e-6


def test_per_scenario_params():
    """Domain-randomized quadrotors: (B, 4) params solve per-scenario
    physics (different masses hover at different thrusts)."""
    B, T = 8, 12
    dx, cost, config = _setup(T, B, lqr_iter=6)
    rng = np.random.default_rng(11)
    params_b = jnp.asarray(
        np.asarray(dx.params) * rng.uniform(0.85, 1.15, (B, 4)), jnp.float32
    )
    x0 = 0.0 * _x_init(B)  # start exactly at hover position
    sol = jax.jit(
        lambda x, p: mpc_solve(
            config, x, cost, dx.replace(params=p), u_lower=0.0, u_upper=5.0
        )
    )(x0, params_b)
    assert bool(jnp.all(jnp.isfinite(sol.us)))
    # NOTE: the cost is built from the NOMINAL hover thrust, so the solver
    # balances gravity (physics, per-scenario) against the control
    # setpoint (cost, shared): heavier scenarios must thrust MORE than
    # lighter ones — monotone in mass*g. Assert at an EARLY step: near the
    # horizon end V_T = 0 makes the last controls track the shared cost
    # setpoint exactly (no dynamics left to pay for), erasing the signal.
    grav = np.asarray(params_b[:, 0] * params_b[:, 1])
    u_mean = np.asarray(jnp.mean(sol.us[1], axis=-1))
    corr = np.corrcoef(grav, u_mean)[0, 1]
    assert corr > 0.9, corr


def test_sysid_recovers_identifiable_combinations():
    """il_quadrotor.py in miniature: log-parameterized sysid halves the
    imitation loss and recovers the identifiable parameter combinations
    (hover thrust g*mass; torque authority arm/inertia) even while g and
    mass individually stay coupled."""
    import optax

    from diffmpc_tpu.parallel import (
        generate_expert_data,
        init_train_state,
        make_dp_train_step,
    )

    B, T = 32, 12
    dx, cost, config = _setup(T, B, lqr_iter=10)
    config = dataclasses.replace(config, detach_unconverged=True)
    x0 = _x_init(B, seed=2, scale=0.25)
    _, ue, _ = jax.jit(
        lambda x: generate_expert_data(config, cost, dx, x, 0.0, 5.0)
    )(x0)
    rng = np.random.default_rng(1)
    log0 = jnp.log(
        jnp.asarray(np.asarray(dx.params) * rng.uniform(0.75, 1.25, 4),
                    jnp.float32)
    )

    def make_problem(lp):
        return cost, dx.replace(params=jnp.exp(lp))

    opt = optax.adam(2e-2)
    step = make_dp_train_step(
        config, make_problem, opt, mesh=None, u_lower=0.0, u_upper=5.0
    )
    st = init_train_state(log0, opt)
    losses = []
    for _ in range(20):
        st, stats = step(st, x0, ue)
        losses.append(float(stats.loss))
    assert losses[-1] < 0.5 * losses[0], losses[::5]
    learned = np.exp(np.asarray(st.params))
    true = np.asarray(dx.params)
    hover0, hover1 = np.exp(log0[0] + log0[1]), learned[0] * learned[1]
    assert abs(hover1 - true[0] * true[1]) < abs(float(hover0) - true[0] * true[1])
    assert abs(hover1 / (true[0] * true[1]) - 1) < 0.05, hover1
