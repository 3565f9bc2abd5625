"""Kinematic-bicycle vehicle env (n=4, m=2): the industrial MPC shape —
lane keeping with an ASYMMETRIC mixed box (accel [-6, 3], steer
[-0.5, 0.5]) through the m=2 active-set enumeration.

Physics pins use IMPLEMENTATION-INDEPENDENT invariants (the acrobot
energy-conservation idiom): the straight-line closed form and the exact
circular-motion radius R = L / tan(delta) — both analytic consequences
of the kinematics, not re-transcriptions of the step formula."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffmpc_tpu import MPCConfig, QuadCost, mpc_solve
from diffmpc_tpu.models import VehicleDx

U_LO = np.array([-6.0, -0.5])
U_HI = np.array([3.0, 0.5])


def _x_init(B, seed=0, py_scale=1.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        np.stack(
            [
                np.zeros(B),                          # px
                rng.uniform(-py_scale, py_scale, B),  # py (lane offset)
                rng.uniform(-0.3, 0.3, B),            # psi
                rng.uniform(3.0, 7.0, B),             # v
            ],
            -1,
        ),
        jnp.float32,
    )


def _setup(T, B, lqr_iter=10, **kw):
    dx = VehicleDx.default(jnp.float32)
    q, p = dx.get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    kw.setdefault("eps", 1e-5)
    config = MPCConfig(
        n_state=4, n_ctrl=2, T=T, lqr_iter=lqr_iter,
        exit_unconverged=False, detach_unconverged=False, **kw,
    )
    return dx, cost, config


def test_straight_line_closed_form():
    """steer = 0, drag-free: psi and py are constant, v integrates the
    acceleration exactly, px advances by the discrete sum of speeds —
    computable without the implementation."""
    dx = VehicleDx.default(jnp.float64).replace(
        params=jnp.array([2.7, 0.0], jnp.float64)
    )
    x = jnp.asarray([[0.0, 0.3, 0.0, 4.0]], jnp.float64)
    u = jnp.asarray([[1.0, 0.0]], jnp.float64)
    px_expect, v = 0.0, 4.0
    for _ in range(20):
        x = dx.forward(x, u)
        v = v + dx.dt * 1.0
        px_expect += dx.dt * v
    np.testing.assert_allclose(float(x[0, 3]), v, rtol=1e-12)
    np.testing.assert_allclose(float(x[0, 0]), px_expect, rtol=1e-12)
    np.testing.assert_allclose(float(x[0, 1]), 0.3, rtol=1e-12)
    np.testing.assert_allclose(float(x[0, 2]), 0.0, atol=1e-15)


def test_circular_motion_invariant():
    """Constant speed + constant steer: every step applies the SAME rigid
    motion (rotate heading by theta = dt v tan(delta)/L, then advance
    dt v along the new heading), and a rigid motion with nonzero rotation
    is EXACTLY a rotation about its unique fixed point — so the visited
    positions lie exactly on one circle (f64-roundoff-tight), whose
    radius s / (2 sin(theta/2)) approaches the continuous
    R = L / tan(delta) as dt -> 0. An analytic consequence of the
    kinematics, independent of the implementation (the acrobot
    energy-conservation idiom)."""
    L, delta = 2.7, 0.3
    dx = VehicleDx.default(jnp.float64).replace(
        params=jnp.array([L, 0.0], jnp.float64)
    )
    v = 5.0
    s = dx.dt * v
    theta = s * np.tan(delta) / L
    # exact center of the discrete rotation: perpendicular bisector of
    # the first chord s*(cos theta, sin theta)
    half = 0.5 * s * np.array([np.cos(theta), np.sin(theta)])
    normal = np.array([-np.sin(theta), np.cos(theta)])
    c = half + 0.5 * s / np.tan(theta / 2.0) * normal
    R_disc = s / (2.0 * np.sin(theta / 2.0))
    x = jnp.asarray([[0.0, 0.0, 0.0, v]], jnp.float64)
    u = jnp.asarray([[0.0, delta]], jnp.float64)
    radii = []
    for _ in range(int(np.pi / 2 * R_disc / s)):
        x = dx.forward(x, u)
        radii.append(np.hypot(float(x[0, 0]) - c[0], float(x[0, 1]) - c[1]))
    radii = np.asarray(radii)
    np.testing.assert_allclose(radii, R_disc, rtol=1e-9)  # exact circle
    np.testing.assert_allclose(
        R_disc, L / np.tan(delta), rtol=1e-3  # discrete -> continuous
    )
    assert float(x[0, 3]) == v  # drag-free, no accel: speed exact


def test_entries_step_matches_forward():
    dx = VehicleDx.default(jnp.float32)
    rng = np.random.default_rng(3)
    x = jnp.asarray(
        np.stack([rng.normal(size=32), rng.normal(size=32),
                  rng.uniform(-1, 1, 32), rng.uniform(0, 10, 32)], -1),
        jnp.float32,
    )
    u = jnp.asarray(
        np.stack([rng.uniform(-6, 3, 32), rng.uniform(-0.5, 0.5, 32)], -1),
        jnp.float32,
    )
    ref = dx.forward(x, u)
    out = dx.entries_step(
        [dx.params[i] for i in range(2)],
        [x[:, i] for i in range(4)],
        [u[:, i] for i in range(2)],
    )
    np.testing.assert_allclose(
        np.stack([np.asarray(o) for o in out], -1), np.asarray(ref),
        rtol=1e-6, atol=1e-6,
    )


def test_asymmetric_bound_jacobian_full_at_both_edges():
    """Boundary-strict clamp at BOTH asymmetric accel edges (-6 and +3)
    and both steer edges: the control Jacobian at the exact bound equals
    the Jacobian just inside (bclamp convention; the zoo-wide test only
    exercises one scalar bound per env)."""
    dx = VehicleDx.default(jnp.float32)
    x = jnp.asarray([[0.0, 0.2, 0.1, 5.0]], jnp.float32)
    for u_edge in (
        [3.0, 0.0], [-6.0, 0.0], [0.0, 0.5], [0.0, -0.5], [3.0, 0.5],
    ):
        u_at = jnp.asarray([u_edge], jnp.float32)
        u_in = u_at * (1.0 - 1e-3)
        _, B_at = dx.grad_input(x, u_at)
        _, B_in = dx.grad_input(x, u_in)
        assert float(jnp.max(jnp.abs(B_at))) > 0.0
        np.testing.assert_allclose(
            np.asarray(B_at), np.asarray(B_in), rtol=5e-2, atol=1e-4,
            err_msg=f"Jacobian shrank at bound {u_edge}",
        )


def test_mpc_lane_keeping_converges():
    """Offset lane starts regulate toward the lane at speed: objective
    improves, final lateral offset and heading shrink, controls respect
    the asymmetric box."""
    B, T = 64, 20
    dx, cost, config = _setup(T, B)
    x0 = _x_init(B, seed=1)
    sol = jax.jit(
        lambda x: mpc_solve(config, x, cost, dx,
                            u_lower=jnp.asarray(U_LO, jnp.float32),
                            u_upper=jnp.asarray(U_HI, jnp.float32))
    )(x0)
    assert bool(jnp.all(jnp.isfinite(sol.objs)))
    assert bool(jnp.all(sol.us[..., 0] >= -6.0 - 1e-5))
    assert bool(jnp.all(sol.us[..., 0] <= 3.0 + 1e-5))
    assert bool(jnp.all(jnp.abs(sol.us[..., 1]) <= 0.5 + 1e-5))
    # the planned terminal lateral error shrinks vs the initial offset
    py0 = np.abs(np.asarray(x0[:, 1]))
    pyT = np.abs(np.asarray(sol.xs[-1, :, 1]))
    assert (pyT < 0.5 * py0 + 0.05).mean() > 0.9, (py0.mean(), pyT.mean())
    assert float(jnp.mean(sol.info.converged)) > 0.9


def test_fused_dispatch_and_interpret_parity():
    """The vehicle rides the mega-kernel (dispatch asserted per the
    CLAUDE.md kernel-test rule) and the fused path matches the XLA
    orchestration at one LQR step (same fixed point — tight)."""
    from diffmpc_tpu.mpc import _would_use_fused

    B, T = 512, 8
    kw = dict(
        n_state=4, n_ctrl=2, T=T, lqr_iter=1, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False,
    )
    config_p = MPCConfig(**kw, use_pallas=True, pallas_interpret=True)
    config_x = MPCConfig(**kw, use_pallas=False)
    dx = VehicleDx.default(jnp.float32)
    q, p = dx.get_true_obj()
    cost = QuadCost(jnp.diag(q), p)
    assert _would_use_fused(
        config_p, dx, is_quad=True, constrained=True, is_lin=False
    )
    x0 = _x_init(B, seed=2)
    lo = jnp.asarray(U_LO, jnp.float32)
    hi = jnp.asarray(U_HI, jnp.float32)
    got = jax.jit(
        lambda x: mpc_solve(config_p, x, cost, dx, u_lower=lo, u_upper=hi)
    )(x0)
    want = jax.jit(
        lambda x: mpc_solve(config_x, x, cost, dx, u_lower=lo, u_upper=hi)
    )(x0)
    # 2e-3 on controls like the zoo's tiny-batch parity test: rare
    # (<0.5%) near-tie active-set picks in the m=2 enumeration vs the
    # XLA path land within ~1e-3 of each other at equal objective
    np.testing.assert_allclose(
        np.asarray(got.us), np.asarray(want.us), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(got.objs), np.asarray(want.objs), rtol=2e-4, atol=2e-4
    )


def test_sysid_recovers_toward_truth():
    """Imitation-learning surface: a perturbed (L, c_d) model trained on
    lane-keeping experts recovers most of the parameter error through
    the KKT backward."""
    import optax

    dx, cost, config = _setup(20, 64, lqr_iter=8)
    config = dataclasses.replace(config, detach_unconverged=True)
    lo = jnp.asarray(U_LO, jnp.float32)
    hi = jnp.asarray(U_HI, jnp.float32)
    x0 = _x_init(64, seed=0)
    u_exp = mpc_solve(config, x0, cost, dx, u_lower=lo, u_upper=hi).us

    rng = np.random.default_rng(0)
    params0 = jnp.asarray(
        np.asarray(dx.params) * rng.uniform(0.7, 1.3, 2), jnp.float32
    )

    def loss(params):
        sol = mpc_solve(
            config, x0, cost, dx.replace(params=params),
            u_lower=lo, u_upper=hi,
        )
        return jnp.mean((sol.us - u_exp) ** 2)

    opt = optax.adam(5e-2)
    st = opt.init(params0)
    prm = params0
    lg = jax.jit(jax.value_and_grad(loss))
    l0 = float(lg(prm)[0])
    for _ in range(30):
        l, g = lg(prm)
        up, st = opt.update(g, st)
        prm = optax.apply_updates(prm, up)
    l1 = float(lg(prm)[0])
    true = np.asarray(dx.params)
    d0 = np.linalg.norm(np.asarray(params0) - true)
    d1 = np.linalg.norm(np.asarray(prm) - true)
    assert l1 < 0.1 * l0, (l0, l1)
    assert d1 < 0.5 * d0, (d0, d1)
