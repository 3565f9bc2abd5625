"""Parallel-in-time (associative-scan) Riccati vs the sequential scan."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from diffmpc_tpu.ops.assoc_riccati import riccati_backward_assoc
from diffmpc_tpu.ops.lqr import lqr_rollout, riccati_backward
from oracles import dense_lqr_kkt, random_lqr_problem


@pytest.mark.parametrize("T,n,m", [(2, 3, 2), (7, 3, 1), (32, 4, 2), (65, 2, 2)])
def test_assoc_matches_sequential(T, n, m):
    rng = np.random.default_rng(300 + T)
    B = 8
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    Cj, cj, Fj, fj = map(jnp.asarray, (C, c, F, f))
    seq = riccati_backward(Cj, cj, Fj, fj, n)
    par = riccati_backward_assoc(Cj, cj, Fj, fj, n)
    np.testing.assert_allclose(np.asarray(par.K), np.asarray(seq.K), atol=1e-8)
    np.testing.assert_allclose(np.asarray(par.k), np.asarray(seq.k), atol=1e-8)


def test_assoc_solution_matches_dense_kkt():
    rng = np.random.default_rng(400)
    T, B, n, m = 12, 6, 3, 2
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    Cj, cj, Fj, fj, x0 = map(jnp.asarray, (C, c, F, f, x_init))
    par = riccati_backward_assoc(Cj, cj, Fj, fj, n)
    xs, us = lqr_rollout(x0, Fj, fj, par.K, par.k)
    xs_o, us_o, _ = dense_lqr_kkt(C, c, F, f, x_init)
    np.testing.assert_allclose(np.asarray(us), us_o, atol=1e-7)
    np.testing.assert_allclose(np.asarray(xs), xs_o, atol=1e-7)


@pytest.mark.parametrize(
    "T,n,m,D", [(16, 3, 1, 4), (64, 3, 2, 8), (120, 2, 1, 12), (32, 4, 2, 32)]
)
def test_blocked_matches_sequential(T, n, m, D):
    """Single-chip blocked parallel-in-time Riccati (same arithmetic the
    time-sharded mesh path distributes) == sequential scan.
    D=T (every block one step) exercises the degenerate all-combine edge."""
    from diffmpc_tpu.ops.assoc_riccati import riccati_backward_blocked

    rng = np.random.default_rng(600 + T)
    B = 4
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    Cj, cj, Fj, fj = map(jnp.asarray, (C, c, F, f))
    seq = riccati_backward(Cj, cj, Fj, fj, n)
    par = riccati_backward_blocked(Cj, cj, Fj, fj, n, n_blocks=D)
    np.testing.assert_allclose(np.asarray(par.K), np.asarray(seq.K), atol=1e-8)
    np.testing.assert_allclose(np.asarray(par.k), np.asarray(seq.k), atol=1e-8)


def test_blocked_requires_divisible_horizon():
    from diffmpc_tpu.ops.assoc_riccati import riccati_backward_blocked

    rng = np.random.default_rng(601)
    C, c, F, f, _ = random_lqr_problem(rng, 10, 2, 3, 1)
    with pytest.raises(ValueError, match="divisible"):
        riccati_backward_blocked(
            jnp.asarray(C), jnp.asarray(c), jnp.asarray(F), jnp.asarray(f),
            3, n_blocks=4,
        )


@pytest.mark.parametrize("T,n,m", [(16, 3, 1), (64, 3, 2), (120, 2, 1)])
def test_time_sharded_matches_sequential(T, n, m):
    """the horizon-sharded deployment of the associative
    Riccati (8-device time mesh) reproduces the sequential scan."""
    import jax
    from diffmpc_tpu.ops.assoc_riccati import riccati_backward_time_sharded

    rng = np.random.default_rng(500 + T)
    B = 4
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    Cj, cj, Fj, fj = map(jnp.asarray, (C, c, F, f))
    seq = riccati_backward(Cj, cj, Fj, fj, n)
    mesh = jax.make_mesh((8,), ("time",))
    par = jax.jit(
        lambda a, b, d, e: riccati_backward_time_sharded(mesh, a, b, d, e, n)
    )(Cj, cj, Fj, fj)
    np.testing.assert_allclose(np.asarray(par.K), np.asarray(seq.K), atol=1e-8)
    np.testing.assert_allclose(np.asarray(par.k), np.asarray(seq.k), atol=1e-8)


def test_time_sharded_requires_divisible_horizon():
    import jax
    from diffmpc_tpu.ops.assoc_riccati import riccati_backward_time_sharded

    rng = np.random.default_rng(501)
    C, c, F, f, _ = random_lqr_problem(rng, 10, 2, 3, 1)
    mesh = jax.make_mesh((8,), ("time",))
    with pytest.raises(ValueError, match="divisible"):
        riccati_backward_time_sharded(
            mesh, jnp.asarray(C), jnp.asarray(c), jnp.asarray(F), jnp.asarray(f), 3
        )


@pytest.mark.skipif(
    not os.environ.get("DIFFMPC_PERF_TESTS"),
    reason="wall-clock assertion on an oversubscribed virtual mesh — "
    "meaningless on a loaded box and ~minutes of suite time; run with "
    "DIFFMPC_PERF_TESTS=1 (correctness of the time-sharded path is "
    "covered by the tests above)",
)
def test_time_sharded_crossover_measurement():
    """Crossover measurement: at long T and
    small B on the 8-device CPU mesh, the time-sharded assoc path beats the
    single-stream sequential scan (per-device sequential depth T/D + D vs
    T). Prints timings; asserts only a generous bound to avoid CI flake."""
    import time
    import jax
    from diffmpc_tpu.ops.assoc_riccati import riccati_backward_time_sharded

    rng = np.random.default_rng(502)
    # the crossover regime: long horizon, small batch, m ~ n (the combine
    # works on n-sized value maps while the sequential step factors the
    # (n+m)-sized Q, so the work ratio favors sharding as m grows; at m=1
    # the sequential step is nearly free and sharding loses — measured
    # 2026-08-17 on the 4-core/8-virtual-device CPU mesh:
    #   T=4096 B=64 n=3 m=1: 0.59x   T=4096 B=16 n=4 m=4: 1.40x
    #   T=8192 B=8  n=4 m=4: 1.76x   T=16384 B=16 n=4 m=4: 1.37x
    T, B, n, m = 8192, 8, 4, 4
    C, c, F, f, _ = random_lqr_problem(rng, T, B, n, m)
    Cj, cj, Fj, fj = map(lambda a: jnp.asarray(a, jnp.float32), (C, c, F, f))

    seq_fn = jax.jit(lambda a, b, d, e: riccati_backward(a, b, d, e, n).K)
    mesh = jax.make_mesh((8,), ("time",))
    par_fn = jax.jit(
        lambda a, b, d, e: riccati_backward_time_sharded(mesh, a, b, d, e, n).K
    )

    jax.block_until_ready(seq_fn(Cj, cj, Fj, fj))
    jax.block_until_ready(par_fn(Cj, cj, Fj, fj))

    def bench(fn, iters=5, loops=3):
        # best-of interleaving-friendly minimum: a contended CI box slows a
        # single loop arbitrarily; the min is the honest number
        best = float("inf")
        for _ in range(loops):
            t0 = time.perf_counter()
            for _ in range(iters):
                r = fn(Cj, cj, Fj, fj)
            jax.block_until_ready(r)
            best = min(best, (time.perf_counter() - t0) / iters)
        return best

    t_seq = bench(seq_fn)
    t_par = bench(par_fn)
    print(f"\n[time-sharded riccati] T={T} B={B}: sequential {t_seq*1e3:.1f}ms, "
          f"8-device time-sharded {t_par*1e3:.1f}ms "
          f"(speedup {t_seq/t_par:.2f}x)")
    # correctness at this shape too (f32 tolerance over a long horizon)
    K_seq = seq_fn(Cj, cj, Fj, fj)
    K_par = par_fn(Cj, cj, Fj, fj)
    np.testing.assert_allclose(np.asarray(K_par), np.asarray(K_seq), atol=5e-4)
    # measured 1.76x at this shape; assert the win with a wide margin —
    # the 8-virtual-device mesh oversubscribes 4 physical cores, so a
    # loaded CI box can eat much of the speedup (best-of-3 above already
    # filters transient noise; this bound only requires "not clearly
    # losing", the measured margin is pinned in the message)
    assert t_par < 1.4 * t_seq, (t_par, t_seq)
