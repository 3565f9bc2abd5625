"""Unconstrained LQR correctness: Riccati+rollout vs dense KKT oracle.

Mirrors the reference's LQR correctness tests (SURVEY.md §4, row 1) and the
driver's eval config 1 (n=3, m=2, T=10, B=32, CPU-runnable)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffmpc_tpu.ops import (
    lqr_linesearch_rollout,
    lqr_rollout,
    riccati_backward,
    trajectory_cost,
)
from oracles import dense_lqr_kkt, random_lqr_problem


@pytest.mark.parametrize("T,B,n,m", [(10, 32, 3, 2), (5, 4, 4, 3), (2, 3, 2, 1)])
def test_riccati_matches_dense_kkt(T, B, n, m):
    rng = np.random.default_rng(0)
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    xs_o, us_o, _ = dense_lqr_kkt(C, c, F, f, x_init)

    res = riccati_backward(jnp.asarray(C), jnp.asarray(c), jnp.asarray(F), jnp.asarray(f), n)
    xs, us = lqr_rollout(jnp.asarray(x_init), jnp.asarray(F), jnp.asarray(f), res.K, res.k)

    np.testing.assert_allclose(np.asarray(xs), xs_o, atol=1e-7)
    np.testing.assert_allclose(np.asarray(us), us_o, atol=1e-7)
    assert bool(jnp.all(res.free_mask))


def test_riccati_f32_parity():
    """f32 (the kernels' dtype) agrees with the f64 oracle to the 1e-4 parity
    budget (BASELINE.md control-sequence parity row)."""
    rng = np.random.default_rng(1)
    T, B, n, m = 20, 16, 4, 2
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    xs_o, us_o, _ = dense_lqr_kkt(C, c, F, f, x_init)

    as32 = lambda a: jnp.asarray(a, jnp.float32)
    res = riccati_backward(as32(C), as32(c), as32(F), as32(f), n)
    xs, us = lqr_rollout(as32(x_init), as32(F), as32(f), res.K, res.k)
    np.testing.assert_allclose(np.asarray(xs), xs_o, atol=1e-4)
    np.testing.assert_allclose(np.asarray(us), us_o, atol=1e-4)


def test_solution_beats_perturbations():
    """Optimality: solver cost <= cost of perturbed control sequences."""
    rng = np.random.default_rng(2)
    T, B, n, m = 8, 8, 3, 2
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    res = riccati_backward(jnp.asarray(C), jnp.asarray(c), jnp.asarray(F), jnp.asarray(f), n)
    xs, us = lqr_rollout(jnp.asarray(x_init), jnp.asarray(F), jnp.asarray(f), res.K, res.k)
    obj = trajectory_cost(jnp.asarray(C), jnp.asarray(c), xs, us)

    def obj_of_us(us_pert):
        # roll out an arbitrary open-loop control sequence
        def step(x, inp):
            Ft, ft, ut = inp
            tau = jnp.concatenate([x, ut], axis=-1)
            return jnp.einsum("bij,bj->bi", Ft, tau) + ft, (x, ut)

        _, (xs_p, us_p) = jax.lax.scan(
            step, jnp.asarray(x_init), (jnp.asarray(F), jnp.asarray(f), us_pert)
        )
        return trajectory_cost(jnp.asarray(C), jnp.asarray(c), xs_p, us_p)

    for seed in range(3):
        pert = us + 0.1 * jnp.asarray(
            np.random.default_rng(seed).standard_normal(us.shape)
        )
        assert bool(jnp.all(obj_of_us(pert) >= obj - 1e-8))


def test_rollout_emits_x_init_first():
    rng = np.random.default_rng(3)
    T, B, n, m = 4, 2, 3, 2
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    res = riccati_backward(jnp.asarray(C), jnp.asarray(c), jnp.asarray(F), jnp.asarray(f), n)
    xs, us = lqr_rollout(jnp.asarray(x_init), jnp.asarray(F), jnp.asarray(f), res.K, res.k)
    assert xs.shape == (T, B, n) and us.shape == (T, B, m)
    np.testing.assert_allclose(np.asarray(xs[0]), x_init)


def test_linesearch_accepts_full_step_on_lqr():
    """On an exact LQR model the full Newton step (alpha=1) must be accepted
    for every batch element when starting from a suboptimal trajectory."""
    rng = np.random.default_rng(4)
    T, B, n, m = 6, 8, 3, 2
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    Cj, cj, Fj, fj, x0 = map(jnp.asarray, (C, c, F, f, x_init))

    # start from the zero-control trajectory
    u_hat = jnp.zeros((T, B, m))
    K0 = jnp.zeros((T, B, m, n))
    x_hat, _ = lqr_rollout(x0, Fj, fj, K0, u_hat)

    # delta-formulation around (x_hat, u_hat): cost linear term expanded at
    # tau_hat, dynamics residual zero (dynamics already linear)
    tau_hat = jnp.concatenate([x_hat, u_hat], axis=-1)
    c_delta = cj + jnp.einsum("tbij,tbj->tbi", Cj, tau_hat)
    res = riccati_backward(Cj, c_delta, Fj, None, n)
    ls = lqr_linesearch_rollout(
        x0, Cj, cj, Fj, fj, res.K, res.k, x_hat, u_hat, decay=0.5, max_iter=6
    )
    assert bool(jnp.all(ls.improved))
    np.testing.assert_allclose(np.asarray(ls.alpha), 1.0)
    xs_o, us_o, _ = dense_lqr_kkt(C, c, F, f, x_init)
    np.testing.assert_allclose(np.asarray(ls.us), us_o, atol=1e-7)
