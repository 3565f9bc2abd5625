"""The kernels' shared entry-wise math (ops/pallas/riccati.py) vs the XLA
reference implementation (ops/lqr.py, ops/pnqp.py).

Both Pallas kernels build their Riccati steps from the same entry helpers
(Cholesky, masked solves, the box QP, the value update). Here a Riccati
sweep is assembled from those helpers on plain ``(B,)`` vectors, outside
any kernel, and compared with :func:`diffmpc_tpu.ops.lqr.riccati_backward`
in each of its three constraint modes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from diffmpc_tpu.ops.lqr import lqr_rollout, riccati_backward
from diffmpc_tpu.ops.pallas.riccati import (
    _cho_solve_entries,
    _chol_entries,
    _masked_chol_solve,
    _pnqp_entries,
    _use_exact_value_update,
    _value_update,
)
from diffmpc_tpu.ops.pnqp import pnqp
from oracles import random_lqr_problem


def _as32(*arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _entry_riccati(C, c, F, f, n, mode, lo=None, hi=None, mask=None,
                   reg=1e-9, pnqp_iter=12):
    """Backward Riccati recursion from the kernels' entry helpers; returns
    ``(K (T,B,m,n), k (T,B,m), free (T,B,m))``."""
    T, B, nm = c.shape
    m = nm - n
    zero = jnp.zeros((B,), jnp.float32)
    V = [[zero] * n for _ in range(n)]
    v = [zero] * n
    exact = _use_exact_value_update(mode, m, reg)
    Ks, ks, frees = [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        Ft = [[F[t, :, a, b] for b in range(nm)] for a in range(n)]
        ft = [f[t, :, a] for a in range(n)]
        W = [[sum(V[k][l] * Ft[l][j] for l in range(n)) for j in range(nm)]
             for k in range(n)]
        z = [sum(V[k][l] * ft[l] for l in range(n)) + v[k] for k in range(n)]
        Q = [[C[t, :, a, b] + sum(Ft[k][a] * W[k][b] for k in range(n))
              for b in range(nm)] for a in range(nm)]
        q = [c[t, :, a] + sum(Ft[k][a] * z[k] for k in range(n))
             for a in range(nm)]
        Quu = [[Q[n + a][n + b] for b in range(m)] for a in range(m)]
        Qux = [[Q[n + a][b] for b in range(n)] for a in range(m)]
        qu = [q[n + a] for a in range(m)]
        cols = [[Qux[a][b] for a in range(m)] for b in range(n)]
        if mode == "box":
            kt, frozen, _ = _pnqp_entries(
                Quu, qu, [lo[t, :, a] for a in range(m)],
                [hi[t, :, a] for a in range(m)], m, pnqp_iter, reg,
            )
            K_cols = _masked_chol_solve(Quu, cols, frozen, m, reg)
        elif mode == "mask":
            frozen = [mask[t, :, a].astype(jnp.float32) for a in range(m)]
            sols = _masked_chol_solve(Quu, cols + [qu], frozen, m, reg)
            K_cols, kt = sols[:n], [-x for x in sols[n]]
        else:
            frozen = [zero] * m
            L = _chol_entries(Quu, m, reg)
            K_cols = [_cho_solve_entries(L, col, m) for col in cols]
            kt = [-x for x in _cho_solve_entries(L, qu, m)]
        K = [[-K_cols[b][a] for b in range(n)] for a in range(m)]
        V, v = _value_update(Q, q, Quu, qu, K, kt, n, m, exact)
        Ks[t] = jnp.stack([jnp.stack(row, -1) for row in K], -2)
        ks[t] = jnp.stack(kt, -1)
        frees[t] = jnp.stack([1.0 - x for x in frozen], -1) > 0.5
    return jnp.stack(Ks), jnp.stack(ks), jnp.stack(frees)


@pytest.mark.parametrize("n,m", [(3, 1), (4, 2), (3, 3)])
def test_pallas_free_mode_matches_xla(n, m):
    rng = np.random.default_rng(60 + n * 10 + m)
    T, B = 6, 64
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    Cj, cj, Fj, fj = _as32(C, c, F, f)
    ref = riccati_backward(Cj, cj, Fj, fj, n)
    K, k, free = _entry_riccati(Cj, cj, Fj, fj, n, "free")
    np.testing.assert_allclose(np.asarray(K), np.asarray(ref.K), atol=2e-4)
    np.testing.assert_allclose(np.asarray(k), np.asarray(ref.k), atol=2e-4)
    assert bool(jnp.all(free))
    # the gains must also produce the same optimal trajectory
    xs_r, us_r = lqr_rollout(jnp.asarray(x_init, jnp.float32), Fj, fj, ref.K, ref.k)
    xs_p, us_p = lqr_rollout(jnp.asarray(x_init, jnp.float32), Fj, fj, K, k)
    np.testing.assert_allclose(np.asarray(us_p), np.asarray(us_r), atol=5e-4)


@pytest.mark.parametrize("n,m", [(3, 1), (4, 2)])
def test_pallas_box_mode_matches_xla(n, m):
    rng = np.random.default_rng(70 + n * 10 + m)
    T, B = 5, 64
    C, c, F, f, x_init = random_lqr_problem(rng, T, B, n, m)
    Cj, cj, Fj, fj = _as32(C, c, F, f)
    u_hat = jnp.zeros((T, B, m), jnp.float32)
    lo = jnp.full((T, B, m), -0.5, jnp.float32)
    hi = jnp.full((T, B, m), 0.5, jnp.float32)
    ref = riccati_backward(
        Cj, cj, Fj, fj, n, u_lower=lo, u_upper=hi, u_hat=u_hat, pnqp_iter=20
    )
    K, k, free = _entry_riccati(Cj, cj, Fj, fj, n, "box", lo=lo, hi=hi)
    np.testing.assert_allclose(np.asarray(k), np.asarray(ref.k), atol=5e-4)
    np.testing.assert_allclose(np.asarray(K), np.asarray(ref.K), atol=5e-4)
    agree = np.mean(np.asarray(free) == np.asarray(ref.free_mask))
    assert agree > 0.99, agree


def test_pallas_mask_mode_matches_xla():
    rng = np.random.default_rng(80)
    T, B, n, m = 5, 64, 3, 2
    C, c, F, f, _ = random_lqr_problem(rng, T, B, n, m)
    Cj, cj, Fj, fj = _as32(C, c, F, f)
    mask = jnp.asarray(rng.random((T, B, m)) < 0.3)
    ref = riccati_backward(Cj, cj, Fj, None, n, ctrl_mask=mask)
    K, k, free = _entry_riccati(
        Cj, cj, Fj, jnp.zeros_like(Fj[..., 0, :n]), n, "mask", mask=mask
    )
    np.testing.assert_allclose(np.asarray(K), np.asarray(ref.K), atol=2e-4)
    np.testing.assert_allclose(np.asarray(k), np.asarray(ref.k), atol=2e-4)
    np.testing.assert_array_equal(np.asarray(free), np.asarray(~mask))


@pytest.mark.parametrize("m", [1, 2, 3])
def test_entry_box_qp_matches_xla_pnqp(m):
    """The in-kernel box QP (closed form at m=1, active-set enumeration at
    m=2, projected Newton at m=3) against ops/pnqp.py on random strictly
    convex problems with boxes that bind."""
    rng = np.random.default_rng(90 + m)
    B = 256
    A = rng.normal(size=(B, m, m))
    H = jnp.asarray(A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(m), jnp.float32)
    q = jnp.asarray(rng.normal(size=(B, m)) * 2.0, jnp.float32)
    lo = jnp.full((B, m), -0.5, jnp.float32)
    hi = jnp.full((B, m), 0.5, jnp.float32)
    ref = pnqp(H, q, lo, hi, n_iter=40)
    x, frozen, _ = _pnqp_entries(
        [[H[:, i, j] for j in range(m)] for i in range(m)],
        [q[:, i] for i in range(m)],
        [lo[:, i] for i in range(m)],
        [hi[:, i] for i in range(m)],
        m, 12, 1e-9,
    )
    x = jnp.stack(x, -1)
    assert float(jnp.mean(jnp.abs(x) > 0.5 - 1e-6)) > 0.1  # boxes bind
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref.x), atol=1e-4)
