"""Dynamics model zoo + env dynamics tests (SURVEY.md §4 rows 5-6)."""

import jax
import jax.numpy as jnp
import numpy as np

from diffmpc_tpu.models import (
    AffineDynamics,
    CartpoleDx,
    CtrlPassthroughDynamics,
    NNDynamics,
    PendulumDx,
    autodiff_grad_input,
)


def test_affine_dynamics_forward_and_grads():
    rng = np.random.default_rng(30)
    n, m, B = 4, 2, 8
    A = jnp.asarray(rng.standard_normal((n, n)))
    Bm = jnp.asarray(rng.standard_normal((n, m)))
    cv = jnp.asarray(rng.standard_normal(n))
    dx = AffineDynamics(A, Bm, cv)
    x = jnp.asarray(rng.standard_normal((B, n)))
    u = jnp.asarray(rng.standard_normal((B, m)))
    np.testing.assert_allclose(
        np.asarray(dx.forward(x, u)), np.asarray(x @ A.T + u @ Bm.T + cv)
    )
    Ag, Bg = dx.grad_input(x, u)
    assert Ag.shape == (B, n, n) and Bg.shape == (B, n, m)
    Aa, Ba = autodiff_grad_input(dx.forward, x, u)
    np.testing.assert_allclose(np.asarray(Ag), np.asarray(Aa))
    np.testing.assert_allclose(np.asarray(Bg), np.asarray(Ba))


def test_nn_dynamics_shapes_and_jacobians():
    key = jax.random.PRNGKey(0)
    n, m, B = 3, 2, 5
    dx = NNDynamics.init(key, n, m, hidden=(16, 16), dtype=jnp.float64)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, n), jnp.float64)
    u = jax.random.normal(jax.random.PRNGKey(2), (B, m), jnp.float64)
    out = dx.forward(x, u)
    assert out.shape == (B, n)
    A, Bm = dx.grad_input(x, u)  # default autodiff path
    assert A.shape == (B, n, n) and Bm.shape == (B, n, m)
    # directional FD check of the Jacobian
    v = jax.random.normal(jax.random.PRNGKey(3), (n,), jnp.float64)
    h = 1e-6
    fd = (dx.forward(x + h * v, u) - dx.forward(x - h * v, u)) / (2 * h)
    np.testing.assert_allclose(np.asarray(A @ v), np.asarray(fd), atol=1e-6)


def test_ctrl_passthrough_composition():
    key = jax.random.PRNGKey(4)
    n, m, B = 3, 2, 4
    inner = NNDynamics.init(key, n, m, hidden=(8,), dtype=jnp.float64)
    wrap = CtrlPassthroughDynamics(inner=inner, n_ctrl=m)
    x = jax.random.normal(jax.random.PRNGKey(5), (B, m + n), jnp.float64)
    u = jax.random.normal(jax.random.PRNGKey(6), (B, m), jnp.float64)
    out = wrap.forward(x, u)
    assert out.shape == (B, m + n)
    np.testing.assert_allclose(np.asarray(out[:, :m]), np.asarray(u))
    np.testing.assert_allclose(
        np.asarray(out[:, m:]), np.asarray(inner.forward(x[:, m:], u))
    )
    A, Bm = wrap.grad_input(x, u)
    Aa, Ba = autodiff_grad_input(wrap.forward, x, u)
    np.testing.assert_allclose(np.asarray(A), np.asarray(Aa), atol=1e-10)
    np.testing.assert_allclose(np.asarray(Bm), np.asarray(Ba), atol=1e-10)


def test_pendulum_analytic_jacobians_match_autodiff():
    """Closed-form grad_input vs autodiff, including saturated regions
    (ref GradMethods.ANALYTIC / ANALYTIC_CHECK semantics)."""
    dx = PendulumDx.default(jnp.float64)
    rng = np.random.default_rng(31)
    th = rng.uniform(-np.pi, np.pi, 200)
    thdot = rng.uniform(-9, 9, 200)  # beyond the +-8 speed clamp
    u = jnp.asarray(rng.uniform(-3, 3, (200, 1)))  # beyond the +-2 torque clamp
    x = jnp.asarray(np.stack([np.cos(th), np.sin(th), thdot], -1))
    A_an, B_an = dx.grad_input(x, u)
    A_ad, B_ad = autodiff_grad_input(dx.forward, x, u)
    np.testing.assert_allclose(np.asarray(A_an), np.asarray(A_ad), atol=1e-12)
    np.testing.assert_allclose(np.asarray(B_an), np.asarray(B_ad), atol=1e-12)


def test_pendulum_step_hand_computed():
    """One Euler step vs hand-computed ODE values (ref C6 semantics)."""
    dx = PendulumDx.default(jnp.float64)
    g, m, l, dt = 10.0, 1.0, 1.0, 0.05
    th, thdot, u = 2.0, 1.0, 0.5
    x = jnp.asarray([[np.cos(th), np.sin(th), thdot]])
    uu = jnp.asarray([[u]])
    out = np.asarray(dx.forward(x, uu))[0]
    newthdot = thdot + dt * (3 * g / (2 * l) * np.sin(th) + 3 * u / (m * l * l))
    newth = th + dt * newthdot
    np.testing.assert_allclose(out, [np.cos(newth), np.sin(newth), newthdot], atol=1e-12)


def test_pendulum_speed_and_torque_limits():
    dx = PendulumDx.default(jnp.float64)
    x = jnp.asarray([[np.cos(0.5), np.sin(0.5), 7.9]])
    u = jnp.asarray([[100.0]])  # must be clamped to +-2
    out = np.asarray(dx.forward(x, u))[0]
    assert abs(out[2]) <= 8.0 + 1e-12
    out_clamped = np.asarray(dx.forward(x, jnp.asarray([[2.0]])))[0]
    np.testing.assert_allclose(out, out_clamped, atol=1e-12)


def test_pendulum_state_encoding_consistent():
    """cos^2 + sin^2 stays 1 under rollout."""
    dx = PendulumDx.default(jnp.float64)
    x = jnp.asarray([[np.cos(2.5), np.sin(2.5), -1.0]])
    for _ in range(50):
        x = dx.forward(x, jnp.asarray([[1.5]]))
    r = float(x[0, 0] ** 2 + x[0, 1] ** 2)
    np.testing.assert_allclose(r, 1.0, atol=1e-10)


def test_cartpole_step_hand_computed():
    dx = CartpoleDx.default(jnp.float64)
    g, mc, mp, l, dt = 9.8, 1.0, 0.1, 0.5, 0.05
    p, pdot, th, thdot, u = 0.3, -0.2, 0.4, 0.5, 1.0
    x = jnp.asarray([[p, pdot, np.cos(th), np.sin(th), thdot]])
    out = np.asarray(dx.forward(x, jnp.asarray([[u]])))[0]
    total = mc + mp
    pml = mp * l
    temp = (u + pml * thdot**2 * np.sin(th)) / total
    th_acc = (g * np.sin(th) - np.cos(th) * temp) / (
        l * (4.0 / 3.0 - mp * np.cos(th) ** 2 / total)
    )
    p_acc = temp - pml * th_acc * np.cos(th) / total
    expect = [
        p + dt * pdot,
        pdot + dt * p_acc,
        np.cos(th + dt * thdot),
        np.sin(th + dt * thdot),
        thdot + dt * th_acc,
    ]
    np.testing.assert_allclose(out, expect, atol=1e-12)


def test_cartpole_upright_unstable_equilibrium():
    """Zero state at upright with no force stays put; a perturbed pole
    falls (th grows)."""
    dx = CartpoleDx.default(jnp.float64)
    x_eq = jnp.asarray([[0.0, 0.0, 1.0, 0.0, 0.0]])
    out = np.asarray(dx.forward(x_eq, jnp.asarray([[0.0]])))[0]
    np.testing.assert_allclose(out, np.asarray(x_eq)[0], atol=1e-12)
    x = jnp.asarray([[0.0, 0.0, np.cos(0.05), np.sin(0.05), 0.0]])
    for _ in range(20):
        x = dx.forward(x, jnp.asarray([[0.0]]))
    th = float(jnp.arctan2(x[0, 3], x[0, 2]))
    assert th > 0.05


def test_env_true_obj_minimized_at_goal():
    for dx, goal in [
        (PendulumDx.default(jnp.float64), jnp.asarray([1.0, 0.0, 0.0])),
        (CartpoleDx.default(jnp.float64), jnp.asarray([0.0, 0.0, 1.0, 0.0, 0.0])),
    ]:
        q, p = dx.get_true_obj()
        tau_goal = jnp.concatenate([goal, jnp.zeros(dx.n_ctrl)])

        def cost(tau):
            return 0.5 * jnp.sum(q * tau * tau) + jnp.sum(p * tau)

        g = jax.grad(cost)(tau_goal)
        np.testing.assert_allclose(np.asarray(g), 0.0, atol=1e-12)


def test_get_frame_renders():
    """Smoke test the reference's get_frame surface (Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    pend = PendulumDx.default(jnp.float64)
    ax = pend.get_frame(jnp.asarray([np.cos(0.3), np.sin(0.3), 0.5]))
    assert ax is not None
    cart = CartpoleDx.default(jnp.float64)
    ax = cart.get_frame(jnp.asarray([0.1, 0.0, np.cos(0.2), np.sin(0.2), 0.0]))
    assert ax is not None
    import matplotlib.pyplot as plt

    plt.close("all")


def test_nn_dynamics_entries_step_matches_forward():
    """NNDynamics is kernel-fusable — the entry-tile MLP step
    equals forward() on the same inputs (and kernel_params round-trips the
    weight layout)."""
    import numpy as np

    key = jax.random.PRNGKey(3)
    nn = NNDynamics.init(key, n_state=3, n_ctrl=1, hidden=(8,), activation="tanh")
    assert nn.kernel_fusable
    rng = np.random.default_rng(42)
    S, L = 4, 8  # any tile shape works; entries are elementwise
    x = [jnp.asarray(rng.normal(size=(S, L)), jnp.float32) for _ in range(3)]
    u = [jnp.asarray(rng.normal(size=(S, L)), jnp.float32)]
    params = [p for p in np.asarray(nn.kernel_params())]
    out_entries = nn.entries_step(params, x, u)

    xb = jnp.stack(x, -1).reshape(-1, 3)
    ub = jnp.stack(u, -1).reshape(-1, 1)
    out_fwd = nn.forward(xb, ub)
    got = jnp.stack(out_entries, -1).reshape(-1, 3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(out_fwd), atol=1e-6)

    # residual variant too
    nn_res = NNDynamics(nn.weights, nn.biases, "tanh", True)
    got_r = jnp.stack(nn_res.entries_step(params, x, u), -1).reshape(-1, 3)
    np.testing.assert_allclose(
        np.asarray(got_r), np.asarray(nn_res.forward(xb, ub)), atol=1e-6
    )

    # a large MLP is excluded from kernel fusion
    big = NNDynamics.init(key, 3, 1, hidden=(64, 64))
    assert not big.kernel_fusable


def test_control_jacobian_full_at_exact_bound_all_envs():
    """Boundary-strict clamp convention (load-bearing for box-DDP:
    saturated controls sit EXACTLY on the bound): the control Jacobian at
    u == bound must equal the Jacobian just inside — jnp.clip's 0.5 tie
    gradient would halve torque effectiveness precisely where the box is
    active (utils.batch.bclamp; round-4 review catch)."""
    import numpy as np

    from diffmpc_tpu.models import AcrobotDx, CartpoleDx, QuadrotorDx

    cases = [
        (PendulumDx.default(jnp.float32),
         jnp.asarray([[0.8, 0.6, 0.3]], jnp.float32), 2.0),
        (CartpoleDx.default(jnp.float32),
         jnp.asarray([[0.1, 0.2, 0.95, 0.31, 0.1]], jnp.float32), 10.0),
        (QuadrotorDx.default(jnp.float32),
         jnp.asarray([[0.1, 0.1, 0.1, 0.1, 0.1, 0.1]], jnp.float32), 5.0),
        (AcrobotDx.default(jnp.float32),
         jnp.asarray([[0.99, 0.14, 0.98, -0.2, 0.3, -0.2]], jnp.float32),
         4.0),
    ]
    from diffmpc_tpu.models import VehicleDx

    # vehicle: both dims at their (asymmetric) UPPER bounds via the shared
    # scalar-bound protocol (steer=0.5 is its real edge; accel 0.5 is
    # interior — both asymmetric accel edges are pinned in
    # tests/test_vehicle.py::test_asymmetric_bound_jacobian_full_at_both_edges)
    cases.append(
        (VehicleDx.default(jnp.float32),
         jnp.asarray([[0.0, 0.2, 0.1, 5.0]], jnp.float32), 0.5)
    )
    for dx, x, bound in cases:
        m = dx.n_ctrl
        u_at = jnp.full((1, m), bound, jnp.float32)
        u_in = jnp.full((1, m), bound * (1.0 - 1e-3), jnp.float32)
        _, B_at = dx.grad_input(x, u_at)
        _, B_in = dx.grad_input(x, u_in)
        assert float(jnp.max(jnp.abs(B_at))) > 0.0, type(dx).__name__
        np.testing.assert_allclose(
            np.asarray(B_at), np.asarray(B_in), rtol=5e-2, atol=1e-4,
            err_msg=f"{type(dx).__name__}: control Jacobian shrank at the "
            "exact bound (clip tie gradient)",
        )
