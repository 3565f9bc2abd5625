"""JAX engine vs the native C++ f64 reference solver (ctypes-built)."""

import jax.numpy as jnp
import numpy as np
import pytest

from diffmpc_tpu import MPC, LinDx, QuadCost
from oracles import dense_lqr_kkt, random_lqr_problem

native = pytest.importorskip("diffmpc_tpu.native")


def test_native_builds_and_loads():
    assert native._load() is not None


def test_native_unconstrained_matches_dense_kkt():
    """The C++ engine itself is validated against the dense-KKT oracle."""
    rng = np.random.default_rng(200)
    T, B, n, m = 8, 8, 3, 2
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    xs_o, us_o, _ = dense_lqr_kkt(C, c, F, f, x_init)
    xs, us, objs = native.solve_batch(C, c, F, f, x_init, ilqr_iter=5)
    np.testing.assert_allclose(us, us_o, atol=1e-8)
    np.testing.assert_allclose(xs, xs_o, atol=1e-8)


@pytest.mark.parametrize("m", [1, 2])
def test_jax_engine_matches_native_box(m):
    """f32 JAX box-DDP controls vs the native f64 solve, 1e-4 parity
    (BASELINE.md parity budget; the two implementations share no code)."""
    rng = np.random.default_rng(201 + m)
    T, B, n = 15, 12, 4
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    lo, hi = -0.5, 0.5
    xs_n, us_n, objs_n = native.solve_batch(
        C, c, F, f, x_init,
        u_lower=np.full((T, B, m), lo), u_upper=np.full((T, B, m), hi),
        ilqr_iter=100,
    )
    ctrl = MPC(
        n, m, T, u_lower=lo, u_upper=hi, lqr_iter=100, exit_unconverged=False,
        eps=1e-13, not_improved_lim=10**6,
    )
    # f64: the two (code-independent) implementations must agree exactly
    as64 = lambda a: jnp.asarray(a, jnp.float64)
    _, us64, objs64 = ctrl(as64(x_init), QuadCost(as64(C), as64(c)), LinDx(as64(F), as64(f)))
    np.testing.assert_allclose(np.asarray(us64), us_n, atol=1e-7)
    np.testing.assert_allclose(np.asarray(objs64), objs_n, rtol=1e-9, atol=1e-9)
    # f32 (the GPU path's dtype): parity budget with a small allowance for the f32
    # resolution of the fixed point itself
    as32 = lambda a: jnp.asarray(a, jnp.float32)
    _, us, objs = ctrl(as32(x_init), QuadCost(as32(C), as32(c)), LinDx(as32(F), as32(f)))
    np.testing.assert_allclose(np.asarray(us), us_n, atol=2.5e-4)
    np.testing.assert_allclose(np.asarray(objs), objs_n, rtol=1e-5, atol=1e-5)
