"""The shared Riccati value update (ops/pallas/riccati._value_update) and
the m=2 active-set enumeration pnqp (_pnqp_enum_entries) — round-3 kernel
math. Pins:

- enumeration == converged projected-Newton == the XLA pnqp (exact optimum,
  identical active sets) on random m=2 box QPs;
- the DDP cancellation identity: the simplified value update equals the
  full quadratic form whenever K/kt are exact masked solves (any frozen
  pattern), in both mask mode and box-m<=2 mode;
- kernel-level: the mega-kernel compiled with the simplified update matches
  the full-form build tightly at lqr_iter=1 (same fixed point, no chaos).
"""

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp
import pytest

from diffmpc_tpu.ops.pallas import riccati as R
from diffmpc_tpu.ops.pnqp import pnqp

S = 2  # rows of the entry arrays (the helpers are shape-agnostic)
B = S * 128


def _to_tile(x):
    return jnp.asarray(np.asarray(x, np.float32).reshape(S, 128))


def _flat(xs):
    return np.stack([np.asarray(x).reshape(-1) for x in xs], -1)


def _random_box_qp(rng, m, spread=3.0):
    M = rng.normal(size=(B, m, m)).astype(np.float32)
    Quu_b = (M @ M.transpose(0, 2, 1) + 0.5 * np.eye(m, dtype=np.float32))
    qu_b = (spread * rng.normal(size=(B, m))).astype(np.float32)
    lo_b = np.full((B, m), -0.7, np.float32)
    hi_b = np.full((B, m), 0.9, np.float32)
    return Quu_b.astype(np.float32), qu_b, lo_b, hi_b


def _tiles_mm(a):
    m = a.shape[1]
    return [[_to_tile(a[:, i, j]) for j in range(m)] for i in range(m)]


def _tiles_m(a):
    return [_to_tile(a[:, i]) for i in range(a.shape[1])]


def test_pnqp_enum_matches_loop_and_xla_m2():
    rng = np.random.default_rng(0)
    Quu_b, qu_b, lo_b, hi_b = _random_box_qp(rng, 2)
    Quu, qu = _tiles_mm(Quu_b), _tiles_m(qu_b)
    lo, hi = _tiles_m(lo_b), _tiles_m(hi_b)

    xe, fre, nqe = R._pnqp_enum_entries(Quu, qu, lo, hi, 2, 1e-9)
    old = R._PNQP_ENUM
    try:
        R._PNQP_ENUM = "0"
        xl, frl, _ = R._pnqp_entries(Quu, qu, lo, hi, 2, 20, 1e-9)
    finally:
        R._PNQP_ENUM = old
    res = pnqp(
        jnp.asarray(Quu_b), jnp.asarray(qu_b),
        jnp.asarray(lo_b), jnp.asarray(hi_b), n_iter=30,
    )
    xr = np.asarray(res.x)

    Xe, Xl = _flat(xe), _flat(xl)
    np.testing.assert_allclose(Xe, xr, atol=2e-6)
    np.testing.assert_allclose(Xe, Xl, atol=2e-6)
    assert (_flat(fre) == _flat(frl)).all()
    # meaningful problem: a healthy mix of active and free dims
    assert 0.2 < _flat(frl).mean() < 0.9
    assert float(jnp.max(nqe)) == 1.0


@pytest.mark.parametrize("m", [1, 2, 3])
def test_pnqp_enum_matches_xla_all_m(m):
    """The enumeration is m-generic (m=3 behind DIFFMPC_PNQP_ENUM=1):
    pin it against the XLA pnqp at every practical m."""
    rng = np.random.default_rng(m)
    Quu_b, qu_b, lo_b, hi_b = _random_box_qp(rng, m)
    xe, _, _ = R._pnqp_enum_entries(
        _tiles_mm(Quu_b), _tiles_m(qu_b), _tiles_m(lo_b), _tiles_m(hi_b),
        m, 1e-9,
    )
    res = pnqp(
        jnp.asarray(Quu_b), jnp.asarray(qu_b),
        jnp.asarray(lo_b), jnp.asarray(hi_b), n_iter=40,
    )
    np.testing.assert_allclose(_flat(xe), np.asarray(res.x), atol=5e-6)


def test_pnqp_enum_ill_scaled_relative_tolerance():
    """Round-4 advisor fix: KKT-validity tolerances are relative. On an
    ill-scaled QP (|Quu|,|qu| ~ 1e4, f32 roundoff >> 1e-6) an absolute
    tolerance rejects the true active set and the enumeration silently
    degrades to the clipped-Newton safety net; the relative tolerances keep
    it exact. Pinned against the f64 enumeration oracle (the iterative XLA
    pnqp itself converges only to ~1e-3 on this scaling, so it cannot serve
    as the reference here)."""
    from oracles import boxqp_enumerate

    rng = np.random.default_rng(11)
    Quu_b, qu_b, lo_b, hi_b = _random_box_qp(rng, 2)
    scale = np.float32(1e4)
    Quu_b, qu_b = Quu_b * scale, qu_b * scale
    xe, _, _ = R._pnqp_enum_entries(
        _tiles_mm(Quu_b), _tiles_m(qu_b), _tiles_m(lo_b), _tiles_m(hi_b),
        2, 1e-9,
    )
    x_star = boxqp_enumerate(
        Quu_b.astype(np.float64), qu_b.astype(np.float64),
        lo_b.astype(np.float64), hi_b.astype(np.float64),
    )
    np.testing.assert_allclose(_flat(xe), x_star, atol=2e-5)


def test_pnqp_enum_env_read_at_dispatch_time(monkeypatch):
    """Round-4 advisor fix: DIFFMPC_PNQP_ENUM is consulted when the kernel
    is traced, not once at import — setting the env var after
    `import diffmpc_tpu` takes effect on the next fresh trace."""
    monkeypatch.setenv("DIFFMPC_PNQP_ENUM", "0")
    assert not R._pnqp_is_exact("box", 2)
    monkeypatch.setenv("DIFFMPC_PNQP_ENUM", "1")
    assert R._pnqp_is_exact("box", 3)
    monkeypatch.delenv("DIFFMPC_PNQP_ENUM")
    # env unset -> the monkeypatchable module default governs
    assert R._pnqp_is_exact("box", 2)
    monkeypatch.setattr(R, "_PNQP_ENUM", "0")
    assert not R._pnqp_is_exact("box", 2)


@pytest.mark.parametrize("n,m", [(3, 1), (3, 2), (4, 3)])
def test_value_update_identity_mask_mode(n, m):
    """Simplified == full value update when K/kt are exact masked solves
    (the KKT-aux / mask-mode construction), across random frozen masks."""
    rng = np.random.default_rng(7 * n + m)
    nm = n + m
    M = rng.normal(size=(B, nm, nm)).astype(np.float32)
    Q_b = M @ M.transpose(0, 2, 1) + np.eye(nm, dtype=np.float32)
    q_b = rng.normal(size=(B, nm)).astype(np.float32)
    frozen_b = (rng.uniform(size=(B, m)) < 0.4).astype(np.float32)

    Q = [[_to_tile(Q_b[:, a, b]) for b in range(nm)] for a in range(nm)]
    q = [_to_tile(q_b[:, a]) for a in range(nm)]
    Quu = [[Q[n + a][n + b] for b in range(m)] for a in range(m)]
    Qux = [[Q[n + a][b] for b in range(n)] for a in range(m)]
    qu = [q[n + a] for a in range(m)]
    frozen = [_to_tile(frozen_b[:, a]) for a in range(m)]

    reg = 1e-9
    rhs_cols = [[Qux[a][b] for a in range(m)] for b in range(n)] + [qu]
    sols = R._masked_chol_solve(Quu, rhs_cols, frozen, m, reg)
    K = [[-sols[b][a] for b in range(n)] for a in range(m)]
    kt = [-sols[n][a] for a in range(m)]

    V1, v1 = R._value_update(Q, q, Quu, qu, K, kt, n, m, True)
    V0, v0 = R._value_update(Q, q, Quu, qu, K, kt, n, m, False)
    scale = float(np.abs(_flat(v0)).max()) + 1.0
    for a in range(n):
        np.testing.assert_allclose(
            np.asarray(v1[a]), np.asarray(v0[a]), atol=2e-5 * scale
        )
        for b in range(n):
            np.testing.assert_allclose(
                np.asarray(V1[a][b]), np.asarray(V0[a][b]),
                atol=2e-5 * (float(np.abs(_flat([V0[a][b]])).max()) + 1.0),
            )


def test_value_update_identity_box_m2():
    """Box mode with the enumeration pnqp: kt is the exact box optimum,
    K the exact masked solve on pnqp's active set — identity holds."""
    rng = np.random.default_rng(42)
    n, m = 3, 2
    nm = n + m
    M = rng.normal(size=(B, nm, nm)).astype(np.float32)
    Q_b = M @ M.transpose(0, 2, 1) + np.eye(nm, dtype=np.float32)
    q_b = (2.0 * rng.normal(size=(B, nm))).astype(np.float32)

    Q = [[_to_tile(Q_b[:, a, b]) for b in range(nm)] for a in range(nm)]
    q = [_to_tile(q_b[:, a]) for a in range(nm)]
    Quu = [[Q[n + a][n + b] for b in range(m)] for a in range(m)]
    Qux = [[Q[n + a][b] for b in range(n)] for a in range(m)]
    qu = [q[n + a] for a in range(m)]
    lo = [_to_tile(np.full(B, -0.5, np.float32)) for _ in range(m)]
    hi = [_to_tile(np.full(B, 0.5, np.float32)) for _ in range(m)]

    reg = 1e-9
    kt, frozen, _ = R._pnqp_enum_entries(Quu, qu, lo, hi, m, reg)
    rhs_cols = [[Qux[a][b] for a in range(m)] for b in range(n)]
    K_cols = R._masked_chol_solve(Quu, rhs_cols, frozen, m, reg)
    K = [[-K_cols[b][a] for b in range(n)] for a in range(m)]

    V1, v1 = R._value_update(Q, q, Quu, qu, K, kt, n, m, True)
    V0, v0 = R._value_update(Q, q, Quu, qu, K, kt, n, m, False)
    for a in range(n):
        sv = float(np.abs(np.asarray(v0[a])).max()) + 1.0
        np.testing.assert_allclose(
            np.asarray(v1[a]), np.asarray(v0[a]), atol=2e-5 * sv
        )
        for b in range(n):
            sV = float(np.abs(np.asarray(V0[a][b])).max()) + 1.0
            np.testing.assert_allclose(
                np.asarray(V1[a][b]), np.asarray(V0[a][b]), atol=2e-5 * sV
            )


def test_mega_kernel_simplified_vs_full_update(monkeypatch):
    """End to end through the fused solve (interpret mode): the simplified
    build matches the full-form build at lqr_iter=1 (single LQR step —
    same fixed point by construction, tight comparison)."""
    from diffmpc_tpu.ops.pallas.ilqr import ilqr_solve_fused
    from diffmpc_tpu.models import PendulumDx

    dx = PendulumDx.default(jnp.float32)
    qw, p = dx.get_true_obj()
    T, Bs = 6, 256
    C = jnp.broadcast_to(jnp.diag(qw), (T, Bs, 4, 4))
    c = jnp.broadcast_to(p, (T, Bs, 4))
    rng = np.random.default_rng(3)
    th = rng.uniform(-np.pi, np.pi, Bs)
    x0 = jnp.asarray(
        np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, Bs)], -1),
        jnp.float32,
    )
    lo = jnp.full((T, Bs, 1), -2.0, jnp.float32)
    hi = jnp.full((T, Bs, 1), 2.0, jnp.float32)

    def solve():
        fr = ilqr_solve_fused(
            x0, C, c, dx, lo, hi, lqr_iter=1, eps=0.0, interpret=True
        )
        return np.asarray(fr.us), np.asarray(fr.objs)

    # default is the full form (the simplification is off); force the
    # simplified build explicitly
    monkeypatch.setattr(R, "VALUE_UPDATE_EXACT_REG", 1e-6)
    u1, o1 = solve()
    monkeypatch.setattr(R, "VALUE_UPDATE_EXACT_REG", -1.0)
    u0, o0 = solve()
    np.testing.assert_allclose(u1, u0, atol=5e-5)
    np.testing.assert_allclose(o1, o0, atol=5e-4)
