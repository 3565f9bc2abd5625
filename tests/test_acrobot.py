"""Acrobot env (n=6, m=1): the underactuated double pendulum — first env
with a configuration-dependent mass matrix (2x2 closed-form solve inside
the step), exercising the entries_step fusion protocol on rigid-body-style
dynamics. Sign conventions pinned against an independent f64 oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from diffmpc_tpu import MPCConfig, QuadCost, mpc_solve
from diffmpc_tpu.models import AcrobotDx

G = 9.8


def _oracle_step(x, u, p, dt=0.01, max_torque=4.0,
                 ms1=4 * np.pi, ms2=9 * np.pi):
    """Independent f64 acrobot step (Spong EOM, th1 from upright,
    uniform-rod inertias) — NOT a port of the jnp code: M, C, G assembled
    as matrices and solved with np.linalg.solve."""
    m1, m2, l1, l2 = [float(v) for v in p]
    lc1, lc2 = l1 / 2, l2 / 2
    i1, i2 = m1 * l1**2 / 12, m2 * l2**2 / 12
    out = np.zeros_like(x, dtype=np.float64)
    for b in range(x.shape[0]):
        c1, s1, c2, s2, om1, om2 = [float(v) for v in x[b]]
        th1, th2 = np.arctan2(s1, c1), np.arctan2(s2, c2)
        tau = np.clip(float(u[b, 0]), -max_torque, max_torque)
        M = np.array(
            [
                [
                    m1 * lc1**2 + i1
                    + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * np.cos(th2))
                    + i2,
                    m2 * (lc2**2 + l1 * lc2 * np.cos(th2)) + i2,
                ],
                [
                    m2 * (lc2**2 + l1 * lc2 * np.cos(th2)) + i2,
                    m2 * lc2**2 + i2,
                ],
            ]
        )
        h = m2 * l1 * lc2 * np.sin(th2)
        Cvec = np.array([-h * om2**2 - 2 * h * om1 * om2, h * om1**2])
        Gvec = np.array(
            [
                -(m1 * lc1 + m2 * l1) * G * np.sin(th1)
                - m2 * lc2 * G * np.sin(th1 + th2),
                -m2 * lc2 * G * np.sin(th1 + th2),
            ]
        )
        qdd = np.linalg.solve(M, np.array([0.0, tau]) - Cvec - Gvec)
        nom1 = np.clip(om1 + dt * qdd[0], -ms1, ms1)
        nom2 = np.clip(om2 + dt * qdd[1], -ms2, ms2)
        nth1, nth2 = th1 + dt * nom1, th2 + dt * nom2
        out[b] = [np.cos(nth1), np.sin(nth1), np.cos(nth2), np.sin(nth2),
                  nom1, nom2]
    return out


def _x_init(B, seed=0, th_scale=np.pi, om_scale=1.0):
    rng = np.random.default_rng(seed)
    th1 = rng.uniform(-th_scale, th_scale, B)
    th2 = rng.uniform(-th_scale, th_scale, B)
    return jnp.asarray(
        np.stack(
            [
                np.cos(th1), np.sin(th1), np.cos(th2), np.sin(th2),
                rng.uniform(-om_scale, om_scale, B),
                rng.uniform(-om_scale, om_scale, B),
            ],
            -1,
        ),
        jnp.float32,
    )


def _setup(T, B, lqr_iter=10, **kw):
    dx = AcrobotDx.default(jnp.float32)
    q, p = dx.get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    kw.setdefault("eps", 1e-5)
    config = MPCConfig(
        n_state=6, n_ctrl=1, T=T, lqr_iter=lqr_iter,
        exit_unconverged=False, detach_unconverged=False, **kw,
    )
    return dx, cost, config


def test_forward_matches_f64_oracle():
    dx = AcrobotDx.default(jnp.float32)
    rng = np.random.default_rng(11)
    B = 64
    x = np.asarray(_x_init(B, seed=11, om_scale=3.0), np.float64)
    u = rng.uniform(-6.0, 6.0, (B, 1))  # beyond the clamp: pins clamping too
    got = np.asarray(
        dx.forward(jnp.asarray(x, jnp.float32), jnp.asarray(u, jnp.float32))
    )
    want = _oracle_step(x, u, np.asarray(dx.params))
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_both_equilibria():
    """Upright and hanging with zero velocity/torque are fixed points."""
    dx = AcrobotDx.default(jnp.float32)
    for th1 in (0.0, np.pi):
        x = jnp.asarray(
            [[np.cos(th1), np.sin(th1), 1.0, 0.0, 0.0, 0.0]], jnp.float32
        )
        x1 = dx.forward(x, jnp.zeros((1, 1), jnp.float32))
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x), atol=1e-5)


def test_entries_step_matches_forward():
    dx = AcrobotDx.default(jnp.float32)
    x = _x_init(32, seed=3, om_scale=3.0)
    rng = np.random.default_rng(4)
    u = jnp.asarray(rng.uniform(-4, 4, (32, 1)), jnp.float32)
    ref = dx.forward(x, u)
    out = dx.entries_step(
        [dx.params[i] for i in range(4)],
        [x[:, i] for i in range(6)],
        [u[:, 0]],
    )
    np.testing.assert_allclose(
        np.asarray(jnp.stack(out, -1)), np.asarray(ref), atol=1e-5
    )
    # the rotation identity keeps the trig encoding on the unit circle
    stacked = jnp.stack(out, -1)
    for i in (0, 2):
        r = stacked[..., i] ** 2 + stacked[..., i + 1] ** 2
        np.testing.assert_allclose(np.asarray(r), 1.0, atol=1e-5)


def test_mpc_balances_near_upright():
    """Local balance (the classic acrobot control check): uncontrolled,
    the upright state diverges at ~7 rad/s; the elbow torque alone must
    HOLD the state near the goal over the horizon. The assertion is
    against the passive rollout — the honest baseline for an unstable
    equilibrium (driving the error to zero in 0.4 s is not what a
    finite-horizon quadratic-cost plan does)."""
    B, T = 16, 40
    dx, cost, config = _setup(T, B, lqr_iter=20)
    x0 = _x_init(B, seed=5, th_scale=0.05, om_scale=0.05)
    sol = jax.jit(
        lambda x: mpc_solve(config, x, cost, dx, u_lower=-4.0, u_upper=4.0)
    )(x0)
    assert bool(jnp.all(jnp.isfinite(sol.us)))
    goal = jnp.asarray([1.0, 0.0, 1.0, 0.0, 0.0, 0.0], jnp.float32)

    def passive(x, _):
        nxt = dx.forward(x, jnp.zeros((B, 1), jnp.float32))
        return nxt, nxt

    _, xs_passive = jax.lax.scan(passive, x0, None, length=T - 1)
    err_passive = float(
        jnp.mean(jnp.linalg.norm(xs_passive[-1] - goal, axis=-1))
    )
    err0 = float(jnp.mean(jnp.linalg.norm(sol.xs[0] - goal, axis=-1)))
    errT = float(jnp.mean(jnp.linalg.norm(sol.xs[-1] - goal, axis=-1)))
    # passively the pole falls (error grows ~several x); controlled it
    # must stay in the upright neighborhood
    assert err_passive > 3.0 * err0, (err0, err_passive)
    assert errT < 0.25 * err_passive, (errT, err_passive)
    assert errT < 2.0 * err0, (err0, errT)


def test_fused_kernel_matches_xla():
    """Mass-matrix dynamics through the mega-kernel (interpret): the
    entries_step protocol with a state-dependent 2x2 solve."""
    B, T = 512, 8
    dx, cost, config = _setup(T, B, lqr_iter=4, eps=0.0,
                              not_improved_lim=10**6)
    config_x = dataclasses.replace(config, use_pallas=False)
    config_p = dataclasses.replace(
        config, use_pallas=True, pallas_interpret=True
    )
    x0 = _x_init(B, seed=6, th_scale=0.5, om_scale=0.5)
    from diffmpc_tpu.mpc import _would_use_fused

    assert _would_use_fused(
        config_p, dx, is_quad=True, constrained=True, is_lin=False
    )
    ref = jax.jit(
        lambda x: mpc_solve(config_x, x, cost, dx, u_lower=-4.0, u_upper=4.0)
    )(x0)
    out = jax.jit(
        lambda x: mpc_solve(config_p, x, cost, dx, u_lower=-4.0, u_upper=4.0)
    )(x0)
    np.testing.assert_allclose(
        np.asarray(out.objs), np.asarray(ref.objs), rtol=5e-3, atol=5e-3
    )
    close = np.abs(np.asarray(out.us) - np.asarray(ref.us)) < 1e-2
    assert close.mean() > 0.95, close.mean()


def test_sysid_gradients_flow():
    """Gradients w.r.t. the physical params through the KKT backward are
    finite and nonzero — the imitation-learning surface."""
    B, T = 8, 10
    dx, cost, config = _setup(T, B, lqr_iter=3)
    x0 = _x_init(B, seed=7, th_scale=0.5, om_scale=0.5)

    def loss(params):
        sol = mpc_solve(
            config, x0, cost, dx.replace(params=params),
            u_lower=-4.0, u_upper=4.0,
        )
        return jnp.sum(sol.us ** 2)

    g = jax.jit(jax.grad(loss))(jnp.asarray(dx.params))
    assert bool(jnp.all(jnp.isfinite(g)))
    assert float(jnp.max(jnp.abs(g))) > 0.0


def test_sysid_recovers_toward_truth():
    """Imitation-learning surface (eval-config-3 analog): a 20%-perturbed
    model trained on near-upright balance experts recovers most of the
    parameter error — loss drops >10x and the param distance shrinks
    (exact recovery is identifiability-limited in this regime, like the
    quadrotor's)."""
    import optax

    dx, cost, config = _setup(25, 64, lqr_iter=10)
    config = dataclasses.replace(config, detach_unconverged=True)
    x0 = _x_init(64, seed=0, th_scale=0.08, om_scale=0.2)
    u_exp = mpc_solve(config, x0, cost, dx, u_lower=-4.0, u_upper=4.0).us

    rng = np.random.default_rng(0)
    params0 = jnp.asarray(
        np.asarray(dx.params) * rng.uniform(0.8, 1.2, 4), jnp.float32
    )

    def loss(params):
        sol = mpc_solve(
            config, x0, cost, dx.replace(params=params),
            u_lower=-4.0, u_upper=4.0,
        )
        return jnp.mean((sol.us - u_exp) ** 2)

    opt = optax.adam(2e-2)
    st = opt.init(params0)
    prm = params0
    lg = jax.jit(jax.value_and_grad(loss))
    l0 = float(lg(prm)[0])
    for _ in range(25):
        l, g = lg(prm)
        up, st = opt.update(g, st)
        prm = optax.apply_updates(prm, up)
    l1 = float(lg(prm)[0])
    true = np.asarray(dx.params)
    d0 = np.linalg.norm(np.asarray(params0) - true)
    d1 = np.linalg.norm(np.asarray(prm) - true)
    assert l1 < 0.1 * l0, (l0, l1)
    # 0.7: the near-upright balance data identifies the torque-relevant
    # combinations, not all four params individually (measured 0.54x at
    # this seed; the strong claim is the 10x control-MSE drop above)
    assert d1 < 0.7 * d0, (d0, d1)
