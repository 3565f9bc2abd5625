"""Fully-fused iLQR mega-kernel vs the XLA orchestration (interpret mode)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffmpc_tpu import MPCConfig, QuadCost, mpc_solve
from diffmpc_tpu.models import CartpoleDx, PendulumDx
from diffmpc_tpu.ops.pallas.ilqr import ilqr_solve_fused


def _pendulum_problem(B=48, T=8):
    dx = PendulumDx.default(jnp.float32)
    q, p = dx.get_true_obj()
    rng = np.random.default_rng(700)
    th = rng.uniform(-np.pi, np.pi, B)
    x_init = jnp.asarray(
        np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1), jnp.float32
    )
    C = jnp.broadcast_to(jnp.diag(q), (T, B, 4, 4)).astype(jnp.float32)
    c = jnp.broadcast_to(p, (T, B, 4)).astype(jnp.float32)
    lo = jnp.full((T, B, 1), -2.0, jnp.float32)
    hi = jnp.full((T, B, 1), 2.0, jnp.float32)
    return dx, C, c, x_init, lo, hi


@pytest.mark.parametrize("lqr_iter", [1, 4])
def test_fused_matches_xla_orchestration_pendulum(lqr_iter):
    B, T = 48, 8
    dx, C, c, x_init, lo, hi = _pendulum_problem(B, T)
    # XLA reference with identical looping semantics (fixed trip count)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=lqr_iter, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False, use_pallas=False,
    )
    ref = jax.jit(
        lambda x: mpc_solve(config, x, QuadCost(C, c), dx, u_lower=-2.0, u_upper=2.0)
    )(x_init)

    out = ilqr_solve_fused(
        x_init, C, c, dx, lo, hi,
        lqr_iter=lqr_iter, eps=0.0, not_improved_lim=10**6,
        interpret=True,
    )
    # swing-up iLQR is chaotic: over multiple iterations f32-level
    # implementation differences amplify to ~1e-3 in objective (same order
    # as a 1e-5 input perturbation propagated through the XLA path itself),
    # so iteration counts > 1 are compared at chaos tolerance while the
    # single-step case is tight.
    tol = 2e-4 if lqr_iter == 1 else 5e-3
    np.testing.assert_allclose(
        np.asarray(out.objs), np.asarray(ref.objs), rtol=tol, atol=tol
    )
    if lqr_iter == 1:
        np.testing.assert_allclose(np.asarray(out.us), np.asarray(ref.us), atol=5e-4)
        np.testing.assert_allclose(
            np.asarray(out.alpha), np.asarray(ref.info.mean_alpha), atol=1e-6
        )
    else:
        close = np.abs(np.asarray(out.us) - np.asarray(ref.us)) < 1e-2
        assert close.mean() > 0.95, close.mean()


def test_fused_cartpole_runs_and_improves():
    B, T = 32, 6
    dx = CartpoleDx.default(jnp.float32)
    q, p = dx.get_true_obj()
    rng = np.random.default_rng(701)
    th = rng.uniform(-0.3, 0.3, B)
    x_init = jnp.asarray(
        np.stack(
            [rng.uniform(-0.5, 0.5, B), rng.uniform(-0.5, 0.5, B),
             np.cos(th), np.sin(th), rng.uniform(-0.5, 0.5, B)], -1,
        ),
        jnp.float32,
    )
    C = jnp.broadcast_to(jnp.diag(q), (T, B, 6, 6)).astype(jnp.float32)
    c = jnp.broadcast_to(p, (T, B, 6)).astype(jnp.float32)
    lo = jnp.full((T, B, 1), -10.0, jnp.float32)
    hi = jnp.full((T, B, 1), 10.0, jnp.float32)
    out = ilqr_solve_fused(x_init, C, c, dx, lo, hi, lqr_iter=4, interpret=True)

    config = MPCConfig(
        n_state=5, n_ctrl=1, T=T, lqr_iter=4, exit_unconverged=False,
        detach_unconverged=False, use_pallas=False,
    )
    ref = jax.jit(
        lambda x: mpc_solve(config, x, QuadCost(C, c), dx, u_lower=-10.0, u_upper=10.0)
    )(x_init)
    np.testing.assert_allclose(
        np.asarray(out.objs), np.asarray(ref.objs), rtol=5e-4, atol=5e-4
    )


def test_mpc_solve_dispatches_to_fused(monkeypatch):
    """With use_pallas=True (forced) and a fusable problem, mpc_solve must
    route through the mega-kernel (verified by interpret-mode monkeypatch
    counting calls)."""
    import diffmpc_tpu.ops.pallas.ilqr as ilqr_mod

    calls = {"n": 0}
    orig = ilqr_mod.ilqr_solve_fused

    def counting(*args, **kwargs):
        calls["n"] += 1
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(ilqr_mod, "ilqr_solve_fused", counting)

    B, T = 520, 5  # not a multiple of the tile: exercises padding
    dx, C, c, x_init, lo, hi = _pendulum_problem(B, T)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=2, exit_unconverged=False,
        detach_unconverged=False, use_pallas=True,
    )
    sol = mpc_solve(config, x_init, QuadCost(C, c), dx, u_lower=-2.0, u_upper=2.0)
    assert calls["n"] == 1
    assert bool(jnp.all(jnp.isfinite(sol.objs)))
    assert sol.us.shape == (T, B, 1)


def test_tiny_batch_dispatches_fused_and_matches_xla(monkeypatch):
    """The dispatch has no batch floor: the kernel pads any B up to one
    tile. Odd tiny B must (a) genuinely dispatch the mega-kernel and (b)
    agree with the XLA orchestration on a fixed-trip config."""
    import diffmpc_tpu.ops.pallas.ilqr as ilqr_mod

    calls = {"n": 0}
    orig = ilqr_mod.ilqr_solve_fused

    def counting(*args, **kwargs):
        calls["n"] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(ilqr_mod, "ilqr_solve_fused", counting)

    for B in (1, 3):
        T = 6
        dx, C, c, x_init, lo, hi = _pendulum_problem(B, T)
        # single LQR step: tight parity (multi-iteration swing-up is
        # chaotic — see test_fused_matches_xla_orchestration_pendulum)
        kw = dict(
            n_state=3, n_ctrl=1, T=T, lqr_iter=1, eps=0.0,
            not_improved_lim=10**6, exit_unconverged=False,
            detach_unconverged=False,
        )
        config_p = MPCConfig(**kw, use_pallas=True, pallas_interpret=True)
        config_x = MPCConfig(**kw, use_pallas=False)
        from diffmpc_tpu.mpc import _would_use_fused

        assert _would_use_fused(
            config_p, dx, is_quad=True, constrained=True, is_lin=False
        )
        before = calls["n"]
        out = jax.jit(
            lambda x: mpc_solve(
                config_p, x, QuadCost(C, c), dx, u_lower=-2.0, u_upper=2.0
            )
        )(x_init)
        assert calls["n"] == before + 1
        ref = jax.jit(
            lambda x: mpc_solve(
                config_x, x, QuadCost(C, c), dx, u_lower=-2.0, u_upper=2.0
            )
        )(x_init)
        assert out.us.shape == (T, B, 1)
        np.testing.assert_allclose(
            np.asarray(out.objs), np.asarray(ref.objs), rtol=5e-4, atol=5e-4
        )
        np.testing.assert_allclose(
            np.asarray(out.us), np.asarray(ref.us), atol=2e-3
        )


def test_fused_warm_start_matches_xla():
    """u_init threads into the mega-kernel's init rollout —
    warm-started fused solve == warm-started XLA solve (fixed-trip config)."""
    B, T = 48, 8
    dx, C, c, x_init, lo, hi = _pendulum_problem(B, T)
    rng = np.random.default_rng(702)
    u_init = jnp.asarray(rng.uniform(-1.5, 1.5, (T, B, 1)), jnp.float32)

    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=1, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False, use_pallas=False,
    )
    ref = jax.jit(
        lambda x, u: mpc_solve(
            config, x, QuadCost(C, c), dx, u_init=u, u_lower=-2.0, u_upper=2.0
        )
    )(x_init, u_init)

    out = ilqr_solve_fused(
        x_init, C, c, dx, lo, hi, u_init=u_init,
        lqr_iter=1, eps=0.0, not_improved_lim=10**6, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(out.objs), np.asarray(ref.objs), rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(np.asarray(out.us), np.asarray(ref.us), atol=5e-4)

    # and a warm start at the cold fixed point converges immediately
    cold = ilqr_solve_fused(
        x_init, C, c, dx, lo, hi, lqr_iter=10, interpret=True,
    )
    warm = ilqr_solve_fused(
        x_init, C, c, dx, lo, hi, u_init=cold.us, lqr_iter=10, interpret=True,
    )
    assert bool(jnp.all(warm.objs <= cold.objs + 1e-4))
    assert int(jnp.max(warm.n_iters)) <= int(jnp.max(cold.n_iters))


def test_fused_stats_truthful():
    """MPCInfo semantics are path-independent — the kernel
    reports real per-scenario iteration counts and pnqp iterations instead
    of fabricated constants."""
    B, T = 48, 8
    dx, C, c, x_init, lo, hi = _pendulum_problem(B, T)
    out = ilqr_solve_fused(
        x_init, C, c, dx, lo, hi, lqr_iter=10, pnqp_iter=8, interpret=True,
    )
    n_it = np.asarray(out.n_iters)
    qp = np.asarray(out.qp_iters)
    assert n_it.shape == (B,) and qp.shape == (B,)
    assert (n_it >= 1).all() and (n_it <= 10).all()
    # budget-bound semantics: unconverged scenarios report exactly the
    # budget, and at least some converged scenarios demonstrably froze
    # early (strictly fewer iterations than the budget)
    conv = np.asarray(out.converged)
    assert conv.any() and not conv.all()  # the fixture spans both regimes
    assert (n_it[~conv] == 10).all()
    assert (n_it[conv] < 10).any()
    assert len(np.unique(n_it[conv])) > 1  # real per-scenario variation
    assert (qp >= 1.0 - 1e-6).all() and (qp <= 8.0 + 1e-6).all()

    # eps=inf: every scenario converges after its first iteration
    one = ilqr_solve_fused(
        x_init, C, c, dx, lo, hi, lqr_iter=10, eps=float("inf"), interpret=True,
    )
    assert (np.asarray(one.n_iters) == 1).all()
    assert np.asarray(one.converged).all()


def test_per_scenario_iters_agree_across_paths():
    """``MPCInfo.iters`` counts the iterations each scenario ran before it
    froze, the same way on both paths; ``n_iters`` is its max."""
    B, T = 48, 8
    dx, C, c, x_init, _, _ = _pendulum_problem(B, T)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=10, eps=1e-4,
        exit_unconverged=False, detach_unconverged=False,
    )
    infos = [
        mpc_solve(
            dataclasses.replace(config, **kw), x_init, QuadCost(C, c), dx,
            u_lower=-2.0, u_upper=2.0,
        ).info
        for kw in (dict(use_pallas=False), dict(pallas_interpret=True))
    ]
    ref, fused = infos
    it = np.asarray(ref.iters)
    assert it.shape == (B,) and len(np.unique(it)) > 1
    assert int(ref.n_iters) == it.max()
    np.testing.assert_array_equal(np.asarray(fused.iters), it)
    assert int(fused.n_iters) == it.max()


@pytest.mark.parametrize("path", ["xla", "fused"])
def test_frozen_scenario_keeps_its_answer(path):
    """A scenario that froze keeps its best trajectory while the rest of
    the batch iterates on: its answer does not depend on ``lqr_iter``
    beyond the iteration it froze at (nor on its batch neighbours)."""
    B, T = 48, 8
    dx, C, c, x_init, _, _ = _pendulum_problem(B, T)
    kw = dict(use_pallas=False) if path == "xla" else dict(pallas_interpret=True)
    sols = [
        mpc_solve(
            MPCConfig(
                n_state=3, n_ctrl=1, T=T, lqr_iter=L, eps=1e-2,
                exit_unconverged=False, detach_unconverged=False, **kw,
            ),
            x_init, QuadCost(C, c), dx, u_lower=-2.0, u_upper=2.0,
        )
        for L in (3, 10)
    ]
    short, long = sols
    frozen = np.asarray(short.info.converged)
    assert frozen.sum() >= B // 2 and int(long.info.n_iters) > 3
    np.testing.assert_array_equal(
        np.asarray(long.us)[:, frozen], np.asarray(short.us)[:, frozen]
    )
    np.testing.assert_array_equal(
        np.asarray(long.info.iters)[frozen], np.asarray(short.info.iters)[frozen]
    )


def test_mpc_solve_fused_path_accepts_warm_start(monkeypatch):
    """The receding-horizon deployment pattern (u_init set) now rides the
    fused fast path instead of falling back to XLA orchestration."""
    import diffmpc_tpu.ops.pallas.ilqr as ilqr_mod

    calls = {"n": 0}
    orig = ilqr_mod.ilqr_solve_fused

    def counting(*args, **kwargs):
        calls["n"] += 1
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(ilqr_mod, "ilqr_solve_fused", counting)

    B, T = 520, 5
    dx, C, c, x_init, lo, hi = _pendulum_problem(B, T)
    u_init = jnp.zeros((T, B, 1), jnp.float32) + 0.3
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=2, exit_unconverged=False,
        detach_unconverged=False, use_pallas=True,
    )
    sol = mpc_solve(
        config, x_init, QuadCost(C, c), dx,
        u_init=u_init, u_lower=-2.0, u_upper=2.0,
    )
    assert calls["n"] == 1
    assert bool(jnp.all(jnp.isfinite(sol.objs)))
    assert int(sol.info.n_iters) >= 1
    assert float(jnp.max(sol.info.qp_iters)) >= 1.0


def test_fused_nn_dynamics_matches_xla():
    """Learned NN dynamics on the mega-kernel path: the
    fused solve with an MLP `entries_step` matches the XLA orchestration."""
    from diffmpc_tpu.models import NNDynamics

    B, T = 48, 6
    key = jax.random.PRNGKey(7)
    # residual MLP around a stable zero init keeps the rollout bounded
    nn = NNDynamics.init(key, n_state=3, n_ctrl=1, hidden=(8,),
                         activation="tanh", residual=True)
    q = jnp.array([1.0, 1.0, 0.1, 0.001], jnp.float32)
    p = jnp.array([-1.0, 0.0, 0.0, 0.0], jnp.float32)
    rng = np.random.default_rng(703)
    x_init = jnp.asarray(rng.normal(size=(B, 3)) * 0.5, jnp.float32)
    C = jnp.broadcast_to(jnp.diag(q), (T, B, 4, 4)).astype(jnp.float32)
    c = jnp.broadcast_to(p, (T, B, 4)).astype(jnp.float32)
    lo = jnp.full((T, B, 1), -2.0, jnp.float32)
    hi = jnp.full((T, B, 1), 2.0, jnp.float32)

    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=1, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False, use_pallas=False,
        grad_method=__import__("diffmpc_tpu").GradMethods.AUTO_DIFF,
    )
    ref = jax.jit(
        lambda x: mpc_solve(config, x, QuadCost(C, c), nn, u_lower=-2.0, u_upper=2.0)
    )(x_init)
    out = ilqr_solve_fused(
        x_init, C, c, nn, lo, hi,
        lqr_iter=1, eps=0.0, not_improved_lim=10**6, interpret=True,
    )
    np.testing.assert_allclose(
        np.asarray(out.objs), np.asarray(ref.objs), rtol=3e-4, atol=3e-4
    )
    np.testing.assert_allclose(np.asarray(out.us), np.asarray(ref.us), atol=1e-3)


def test_fused_multi_control_matches_xla():
    """m=2 through the FULL fused solve: exercises the in-kernel
    multi-control pnqp (Newton + masked Cholesky) and 2-column gain solves
    inside the mega-kernel, not just the standalone Riccati tests."""
    from diffmpc_tpu.models import NNDynamics

    B, T = 48, 6
    key = jax.random.PRNGKey(11)
    nn = NNDynamics.init(key, n_state=3, n_ctrl=2, hidden=(8,),
                         activation="tanh", residual=True)
    q = jnp.array([1.0, 1.0, 0.1, 0.001, 0.002], jnp.float32)
    p = jnp.array([-1.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)
    rng = np.random.default_rng(704)
    x_init = jnp.asarray(rng.normal(size=(B, 3)) * 0.5, jnp.float32)
    C = jnp.broadcast_to(jnp.diag(q), (T, B, 5, 5)).astype(jnp.float32)
    c = jnp.broadcast_to(p, (T, B, 5)).astype(jnp.float32)
    lo = jnp.full((T, B, 2), -1.0, jnp.float32)
    hi = jnp.full((T, B, 2), 1.0, jnp.float32)

    config = MPCConfig(
        n_state=3, n_ctrl=2, T=T, lqr_iter=1, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False, use_pallas=False,
        grad_method=__import__("diffmpc_tpu").GradMethods.AUTO_DIFF,
    )
    ref = jax.jit(
        lambda x: mpc_solve(config, x, QuadCost(C, c), nn, u_lower=-1.0, u_upper=1.0)
    )(x_init)
    out = ilqr_solve_fused(
        x_init, C, c, nn, lo, hi,
        lqr_iter=1, eps=0.0, not_improved_lim=10**6, interpret=True,
    )
    # some controls must actually hit the box for the test to mean anything
    assert float(jnp.mean((jnp.abs(out.us) > 1.0 - 1e-4))) > 0.05
    np.testing.assert_allclose(
        np.asarray(out.objs), np.asarray(ref.objs), rtol=3e-4, atol=3e-4
    )
    np.testing.assert_allclose(np.asarray(out.us), np.asarray(ref.us), atol=1e-3)


@pytest.mark.parametrize("tile", [32, 64])
def test_tile_width_does_not_change_results(tile, monkeypatch):
    """The tile width (scenarios per program, one per GPU thread) is a
    layout choice only: a narrower tile must give the same solve as the
    default, padding included (B=200 fills no tile exactly)."""
    import diffmpc_tpu.ops.pallas.riccati as ric

    B, T = 200, 6
    dx, C, c, x_init, lo, hi = _pendulum_problem(B, T)
    kw = dict(
        lqr_iter=2, pnqp_iter=4, reg=1e-7, decay=0.2,
        max_linesearch_iter=6, eps=0.0, not_improved_lim=10**6,
        interpret=True,
    )
    base = ilqr_solve_fused(x_init, C, c, dx, lo, hi, **kw)
    monkeypatch.setattr(ric, "TILE", tile)
    narrow = ilqr_solve_fused(x_init, C, c, dx, lo, hi, **kw)
    np.testing.assert_allclose(
        np.asarray(narrow.us), np.asarray(base.us), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(narrow.objs), np.asarray(base.objs), rtol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(narrow.n_iters), np.asarray(base.n_iters)
    )


@pytest.mark.parametrize("T", [40, 128, 512])
def test_long_horizon_fused_matches_xla(T):
    """One kernel serves every horizon (its working buffers live in device
    memory, not in a fixed on-chip budget). Regulation around the hanging
    pendulum (a stable equilibrium, control weight 0.1, so the box clamps a
    few steps and no clamp rides an unstable trajectory) is well
    conditioned at any horizon, so a single iLQR step is compared tightly
    against the XLA orchestration. (Swing-up is not: the u=0 initial
    rollout falls, and a swing-up step at T>=128 departs from an f64 solve
    by the whole box width on some scenarios, on either path.)"""
    B = 64
    dx = PendulumDx.default(jnp.float32)
    q, _ = dx.get_true_obj()
    q = q.at[3].set(0.1)
    p = -q * jnp.asarray([-1.0, 0.0, 0.0, 0.0], jnp.float32)
    rng = np.random.default_rng(706 + T)
    th = np.pi + rng.uniform(-0.5, 0.5, B)
    x_init = jnp.asarray(
        np.stack([np.cos(th), np.sin(th), rng.uniform(-0.5, 0.5, B)], -1),
        jnp.float32,
    )
    C = jnp.broadcast_to(jnp.diag(q), (T, B, 4, 4)).astype(jnp.float32)
    c = jnp.broadcast_to(p, (T, B, 4)).astype(jnp.float32)
    lo = jnp.full((T, B, 1), -2.0, jnp.float32)
    hi = jnp.full((T, B, 1), 2.0, jnp.float32)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=1, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False, use_pallas=False,
    )
    ref = jax.jit(
        lambda x: mpc_solve(config, x, QuadCost(C, c), dx, u_lower=-2.0, u_upper=2.0)
    )(x_init)
    out = ilqr_solve_fused(
        x_init, C, c, dx, lo, hi,
        lqr_iter=1, eps=0.0, not_improved_lim=10**6, interpret=True,
    )
    # the box is active on some steps (the test would be weaker without it)
    assert np.any(np.abs(np.asarray(ref.us)) > 1.999)
    # f32 summation order differs between the two paths: controls within
    # 5e-4 (0.01% of the box width); the objective sums T per-step costs,
    # so within 1e-4 per 20 steps
    np.testing.assert_allclose(
        np.asarray(out.objs), np.asarray(ref.objs), rtol=0, atol=1e-4 * T / 20
    )
    np.testing.assert_allclose(np.asarray(out.us), np.asarray(ref.us), atol=5e-4)


def test_vmap_over_instances_fused_path():
    """Model-ensemble idiom: ``vmap(mpc_solve)`` over per-instance dynamics
    params must ride the fused kernels (pallas_call's batching rule adds a
    leading grid dimension) and agree exactly with per-instance solves.

    This pins the interpret-mode semantics (fwd + grad through the fused
    KKT backward).
    """
    B, T = 512, 8
    dx, C, c, x_init, _, _ = _pendulum_problem(B, T)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=4, exit_unconverged=False,
        detach_unconverged=False, use_pallas=True, pallas_interpret=True,
    )
    from diffmpc_tpu.mpc import _would_use_fused

    assert _would_use_fused(
        config, dx, is_quad=True, constrained=True, is_lin=False
    )
    params = jnp.stack([dx.params, dx.params * 1.05, dx.params * 0.95])

    def solve_one(p):
        sol = mpc_solve(
            config, x_init, QuadCost(C, c), dx.replace(params=p),
            u_lower=-2.0, u_upper=2.0,
        )
        return sol.objs, sol.us

    objs, us = jax.jit(jax.vmap(solve_one))(params)
    assert objs.shape == (3, B) and us.shape == (3, T, B, 1)
    ref = jnp.stack([jax.jit(solve_one)(p)[0] for p in params])
    np.testing.assert_array_equal(np.asarray(objs), np.asarray(ref))

    def loss(p):
        sol = mpc_solve(
            config, x_init, QuadCost(C, c), dx.replace(params=p),
            u_lower=-2.0, u_upper=2.0,
        )
        return jnp.mean(sol.us**2)

    g = jax.jit(jax.vmap(jax.grad(loss)))(params)
    g_ref = jnp.stack([jax.jit(jax.grad(loss))(p) for p in params])
    assert bool(jnp.all(jnp.isfinite(g)))
    np.testing.assert_array_equal(np.asarray(g), np.asarray(g_ref))


def test_u_zero_I_on_fused_path(monkeypatch):
    """u_zero_I realizes as the degenerate box lo = hi = 0 — the in-kernel
    pnqp must hold those dims at exactly zero through the mega-kernel."""
    from diffmpc_tpu.models import NNDynamics
    import diffmpc_tpu.ops.pallas.ilqr as ilqr_mod

    calls = {"n": 0}
    orig = ilqr_mod.ilqr_solve_fused

    def counting(*args, **kwargs):
        calls["n"] += 1
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(ilqr_mod, "ilqr_solve_fused", counting)

    B, T = 520, 6
    key = jax.random.PRNGKey(21)
    nn = NNDynamics.init(key, n_state=3, n_ctrl=2, hidden=(8,),
                         activation="tanh", residual=True)
    q = jnp.array([1.0, 1.0, 0.1, 0.001, 0.002], jnp.float32)
    p = jnp.array([-1.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)
    rng = np.random.default_rng(705)
    x_init = jnp.asarray(rng.normal(size=(B, 3)) * 0.5, jnp.float32)
    C = jnp.broadcast_to(jnp.diag(q), (T, B, 5, 5)).astype(jnp.float32)
    c = jnp.broadcast_to(p, (T, B, 5)).astype(jnp.float32)
    config = MPCConfig(
        n_state=3, n_ctrl=2, T=T, lqr_iter=2, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False, use_pallas=True,
    )
    mask = jnp.asarray([False, True])  # second control pinned to zero
    sol = mpc_solve(
        config, x_init, QuadCost(C, c), nn,
        u_lower=-1.0, u_upper=1.0, u_zero_I=mask,
    )
    assert calls["n"] == 1
    np.testing.assert_array_equal(np.asarray(sol.us[..., 1]), 0.0)
    # the free dim must still do real work
    assert float(jnp.mean(jnp.abs(sol.us[..., 0]))) > 1e-3


def test_slew_penalty_rides_fused_path(monkeypatch):
    """slew_rate_penalty reformulates as a control-augmented problem whose
    dynamics wrapper (CtrlPassthroughDynamics) now composes entries_step —
    the augmented solve must genuinely dispatch to the mega-kernel and match
    the XLA orchestration (fixed-trip config)."""
    import diffmpc_tpu.ops.pallas.ilqr as ilqr_mod

    calls = {"n": 0}
    orig = ilqr_mod.ilqr_solve_fused

    def counting(*args, **kwargs):
        calls["n"] += 1
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(ilqr_mod, "ilqr_solve_fused", counting)

    B, T = 520, 5  # not a multiple of the tile: exercises padding
    dx, C, c, x_init, _, _ = _pendulum_problem(B, T)
    prev_u = jnp.full((B, 1), 0.5, jnp.float32)
    kw = dict(u_lower=-2.0, u_upper=2.0, prev_ctrl=prev_u)
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=1, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False, use_pallas=True,
        slew_rate_penalty=0.5,
    )
    sol = mpc_solve(config, x_init, QuadCost(C, c), dx, **kw)
    assert calls["n"] == 1, "augmented slew problem must ride the mega-kernel"
    assert sol.us.shape == (T, B, 1) and sol.xs.shape == (T, B, 3)

    config_x = dataclasses.replace(config, use_pallas=False)
    ref = jax.jit(
        lambda x: mpc_solve(config_x, x, QuadCost(C, c), dx, **kw)
    )(x_init)
    np.testing.assert_allclose(
        np.asarray(sol.objs), np.asarray(ref.objs), rtol=3e-4, atol=3e-4
    )
    np.testing.assert_allclose(np.asarray(sol.us), np.asarray(ref.us), atol=1e-3)
    # the slew penalty must actually bite for this to mean anything: the
    # first control should be pulled toward prev_ctrl vs the no-penalty solve
    free = jax.jit(
        lambda x: mpc_solve(
            dataclasses.replace(config_x, slew_rate_penalty=None),
            x, QuadCost(C, c), dx, u_lower=-2.0, u_upper=2.0,
        )
    )(x_init)
    d_pen = jnp.abs(sol.us[0] - prev_u)
    d_free = jnp.abs(free.us[0] - prev_u)
    assert float(jnp.mean(d_pen)) < float(jnp.mean(d_free))


@pytest.mark.parametrize("seed", range(8))
def test_fused_shape_fuzz_vs_xla(seed):
    """Shape fuzz that genuinely reaches the mega-kernel: random (n, m, T,
    hidden sizes, box tightness, warm start) through `ilqr_solve_fused`
    directly (interpret), compared against the XLA orchestration at
    lqr_iter=1 / eps=0 (deterministic fixed-trip semantics, so tight
    tolerances hold). This sweep exercises the in-kernel jvp linearization,
    m>=1 pnqp, and masked gain solves across layouts the named-env tests
    never hit."""
    from diffmpc_tpu.models import NNDynamics

    rng = np.random.default_rng(2000 + seed)
    n = int(rng.integers(2, 7))
    m = int(rng.integers(1, 4))
    T = int(rng.integers(3, 10))
    depth = int(rng.integers(1, 3))
    hidden = tuple(int(h) for h in rng.choice([4, 6, 8], size=depth))
    B = 32
    nm = n + m
    key = jax.random.PRNGKey(3000 + seed)
    nn = NNDynamics.init(key, n_state=n, n_ctrl=m, hidden=hidden,
                         activation="tanh", residual=True)

    q = jnp.asarray(rng.uniform(0.05, 1.5, nm), jnp.float32)
    p = jnp.asarray(rng.normal(size=nm) * 0.5, jnp.float32)
    x_init = jnp.asarray(rng.normal(size=(B, n)) * 0.5, jnp.float32)
    C = jnp.broadcast_to(jnp.diag(q), (T, B, nm, nm)).astype(jnp.float32)
    c = jnp.broadcast_to(p, (T, B, nm)).astype(jnp.float32)
    bound = float(rng.uniform(0.3, 2.0))
    lo = jnp.full((T, B, m), -bound, jnp.float32)
    hi = jnp.full((T, B, m), bound, jnp.float32)
    u_init = None
    if seed % 2 == 1:
        u_init = jnp.asarray(
            rng.uniform(-bound, bound, (T, B, m)), jnp.float32
        )

    config = MPCConfig(
        n_state=n, n_ctrl=m, T=T, lqr_iter=1, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False, use_pallas=False,
        grad_method=__import__("diffmpc_tpu").GradMethods.AUTO_DIFF,
    )
    ref = jax.jit(
        lambda x: mpc_solve(
            config, x, QuadCost(C, c), nn,
            u_lower=-bound, u_upper=bound, u_init=u_init,
        )
    )(x_init)
    out = ilqr_solve_fused(
        x_init, C, c, nn, lo, hi, u_init=u_init,
        lqr_iter=1, eps=0.0, not_improved_lim=10**6, interpret=True,
    )
    assert bool(jnp.all(jnp.isfinite(out.objs)))
    np.testing.assert_allclose(
        np.asarray(out.objs), np.asarray(ref.objs), rtol=5e-4, atol=5e-4
    )
    np.testing.assert_allclose(np.asarray(out.us), np.asarray(ref.us), atol=2e-3)


@pytest.mark.parametrize("seed", range(6))
def test_fused_knob_combination_fuzz_vs_xla(seed):
    """Knob-INTERACTION fuzz through the mega-kernel (the shape fuzz above
    varies layouts; this varies the knob subset): random combinations of
    {warm start, delta_u, u_zero_I, per-scenario params} in box mode at
    lqr_iter=1 / eps=0 (deterministic fixed-trip semantics) must match the
    XLA path tightly, through the real mpc_solve dispatch (asserting the
    fused path actually engages — CLAUDE.md test-honesty rule)."""
    from diffmpc_tpu.mpc import _would_use_fused

    rng = np.random.default_rng(8200 + seed)
    B, T = 512, 6
    dx = PendulumDx.default(jnp.float32)
    use_warm = bool(rng.integers(0, 2))
    use_delta = bool(rng.integers(0, 2))
    use_zero = bool(rng.integers(0, 2))
    use_bparams = bool(rng.integers(0, 2))
    if use_bparams:
        dx = dx.replace(
            params=jnp.asarray(dx.params)
            * jnp.asarray(rng.uniform(0.95, 1.05, (B, 3)), jnp.float32)
        )
    q, p = PendulumDx.default(jnp.float32).get_true_obj()
    C = jnp.broadcast_to(jnp.diag(q), (T, B, 4, 4)).astype(jnp.float32)
    c = jnp.broadcast_to(p, (T, B, 4)).astype(jnp.float32)
    th = rng.uniform(-np.pi, np.pi, B)
    x = jnp.asarray(
        np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, B)], -1),
        jnp.float32,
    )
    u_init = (
        jnp.asarray(rng.uniform(-0.5, 0.5, (T, B, 1)), jnp.float32)
        if use_warm else None
    )
    u_zero_I = (
        jnp.zeros((T, B, 1), bool).at[T // 2].set(True) if use_zero else None
    )
    kw = dict(
        n_state=3, n_ctrl=1, T=T, lqr_iter=1, eps=0.0,
        not_improved_lim=10**6, exit_unconverged=False,
        detach_unconverged=False,
        delta_u=0.4 if use_delta else None, dtype=jnp.float32,
    )
    config_p = MPCConfig(**kw, use_pallas=True, pallas_interpret=True)
    config_x = MPCConfig(**kw, use_pallas=False)
    assert _would_use_fused(
        config_p, dx, is_quad=True, constrained=True, is_lin=False
    )

    def run(cfg):
        return jax.jit(
            lambda xi: mpc_solve(
                cfg, xi, QuadCost(C, c), dx, u_init=u_init,
                u_lower=-2.0, u_upper=2.0, u_zero_I=u_zero_I,
            )
        )(x)

    got, want = run(config_p), run(config_x)
    np.testing.assert_allclose(
        np.asarray(got.us), np.asarray(want.us), atol=5e-4,
    )
    np.testing.assert_allclose(
        np.asarray(got.objs), np.asarray(want.objs), rtol=2e-4, atol=2e-4,
    )
    if use_zero:
        assert float(jnp.max(jnp.abs(got.us[T // 2]))) <= 1e-6
    if use_delta:
        base = u_init if u_init is not None else jnp.zeros_like(got.us)
        assert float(jnp.max(jnp.abs(got.us - base))) <= 0.4 + 1e-5
