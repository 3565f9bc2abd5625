"""Fused Pallas KKT backward vs the XLA composite backward (interpret
mode): the analytic backward pass gets its own kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffmpc_tpu.ops.lqr_step import LqrSpec, _kkt_backward_impl, lqr_fixed_point
from diffmpc_tpu.ops.pallas.kkt import kkt_backward_fused


def _random_residuals(rng, T, B, n, m, n_tight=0):
    nm = n + m
    A = rng.normal(size=(T, B, nm, nm)) * 0.3
    C = A @ np.swapaxes(A, -1, -2) + np.eye(nm)
    c = rng.normal(size=(T, B, nm))
    F = rng.normal(size=(T, B, n, nm)) * 0.4
    x_star = rng.normal(size=(T, B, n))
    u_star = rng.uniform(-0.9, 0.9, size=(T, B, m))
    lo = np.full((T, B, m), -1.0)
    hi = np.full((T, B, m), 1.0)
    if n_tight:
        # park a random subset of controls exactly on the upper bound
        flat = rng.choice(T * B * m, size=n_tight, replace=False)
        u_flat = u_star.reshape(-1)
        u_flat[flat] = 1.0
        u_star = u_flat.reshape(T, B, m)
    gx = rng.normal(size=(T, B, n))
    gu = rng.normal(size=(T, B, m))
    j = jnp.asarray
    return (j(C, jnp.float32), j(c, jnp.float32), j(F, jnp.float32),
            j(x_star, jnp.float32), j(u_star, jnp.float32),
            j(lo, jnp.float32), j(hi, jnp.float32),
            j(gx, jnp.float32), j(gu, jnp.float32))


@pytest.mark.parametrize("tile", [32, 64])
def test_fused_kkt_tile_width_does_not_change_results(tile, monkeypatch):
    """The tile width is a layout choice only: a narrower tile must give
    the same backward as the default, padding included (B=200)."""
    import diffmpc_tpu.ops.pallas.riccati as rmod

    rng = np.random.default_rng(812)
    T, B, n, m = 8, 200, 3, 1
    C, c, F, x_star, u_star, lo, hi, gx, gu = _random_residuals(
        rng, T, B, n, m, 100
    )
    tight = (u_star <= lo + 1e-6) | (u_star >= hi - 1e-6)
    r = jnp.concatenate([gx, jnp.where(tight, 0.0, gu)], axis=-1)
    tau = jnp.concatenate([x_star, u_star], axis=-1)
    base = kkt_backward_fused(C, c, F, r, tau, tight, interpret=True)
    monkeypatch.setattr(rmod, "TILE", tile)
    narrow = kkt_backward_fused(C, c, F, r, tau, tight, interpret=True)
    for a, b in zip(narrow, base):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6
        )


@pytest.mark.parametrize(
    "T,n,m,n_tight",
    [
        (40, 3, 1, 300),  # pendulum-shaped
        (64, 5, 1, 300),  # cartpole-shaped
        (128, 3, 2, 600),  # multi-control, long horizon
        (1, 3, 1, 0),  # degenerate horizon
    ],
)
def test_fused_kkt_long_horizon_matches_xla(T, n, m, n_tight):
    """One KKT kernel serves every horizon: parity with the XLA composite
    backward at the horizons (and the degenerate T=1) that once needed a
    separate streaming kernel."""
    rng = np.random.default_rng(900 + T * 100 + n * 10 + m)
    B = 24
    C, c, F, x_star, u_star, lo, hi, gx, gu = _random_residuals(
        rng, T, B, n, m, n_tight
    )
    spec = LqrSpec(n_state=n, constrained=True, use_pallas=False)
    res = (x_star[0], C, c, F, jnp.zeros((T, B, n)), x_star, u_star, lo, hi)
    ref = _kkt_backward_impl(spec, res, (gx, gu))

    tight = (u_star <= lo + spec.tight_eps) | (u_star >= hi - spec.tight_eps)
    if n_tight:
        assert bool(jnp.any(tight))
    r = jnp.concatenate([gx, jnp.where(tight, 0.0, gu)], axis=-1)
    tau = jnp.concatenate([x_star, u_star], axis=-1)
    got = kkt_backward_fused(
        C, c, F, r, tau, tight, reg=spec.back_eps, interpret=True
    )
    for g, w in zip(got, ref[:5]):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=5e-5, atol=5e-5
        )


@pytest.mark.parametrize("n,m,n_tight", [(3, 1, 0), (3, 1, 40), (3, 2, 60)])
def test_fused_kkt_matches_xla_backward(n, m, n_tight):
    rng = np.random.default_rng(800 + n * 10 + m)
    T, B = 8, 24
    C, c, F, x_star, u_star, lo, hi, gx, gu = _random_residuals(
        rng, T, B, n, m, n_tight
    )
    spec = LqrSpec(n_state=n, constrained=True, use_pallas=False)
    x_init = x_star[0]
    res = (x_init, C, c, F, jnp.zeros((T, B, n)), x_star, u_star, lo, hi)
    ref = _kkt_backward_impl(spec, res, (gx, gu))
    dx_init_r, dC_r, dc_r, dF_r, df_r = ref[:5]

    tight = (u_star <= lo + spec.tight_eps) | (u_star >= hi - spec.tight_eps)
    if n_tight:
        assert bool(jnp.any(tight))
    r = jnp.concatenate([gx, jnp.where(tight, 0.0, gu)], axis=-1)
    tau = jnp.concatenate([x_star, u_star], axis=-1)
    dx_init, dC, dc, dF, df = kkt_backward_fused(
        C, c, F, r, tau, tight, reg=spec.back_eps, interpret=True
    )

    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(dx_init), np.asarray(dx_init_r), **tol)
    np.testing.assert_allclose(np.asarray(dc), np.asarray(dc_r), **tol)
    np.testing.assert_allclose(np.asarray(dC), np.asarray(dC_r), **tol)
    np.testing.assert_allclose(np.asarray(df), np.asarray(df_r), **tol)
    np.testing.assert_allclose(np.asarray(dF), np.asarray(dF_r), **tol)


@pytest.mark.parametrize("seed", range(5))
def test_fused_kkt_shape_fuzz(seed):
    """Random (T, n, m, tight fraction) through the fused KKT kernel vs the
    XLA composite backward — edge layouts (T=1/2, n=1, m >= n) beyond the
    fixed-shape cases above."""
    rng = np.random.default_rng(900 + seed)
    T = int(rng.integers(1, 10))
    n = int(rng.integers(1, 6))
    m = int(rng.integers(1, 4))
    B = 24
    n_tight = int(rng.integers(0, max(1, T * B * m // 4)))
    C, c, F, x_star, u_star, lo, hi, gx, gu = _random_residuals(
        rng, T, B, n, m, n_tight
    )
    spec = LqrSpec(n_state=n, constrained=True, use_pallas=False)
    res = (x_star[0], C, c, F, jnp.zeros((T, B, n)), x_star, u_star, lo, hi)
    ref = _kkt_backward_impl(spec, res, (gx, gu))
    dx_init_r, dC_r, dc_r, dF_r, df_r = ref[:5]

    tight = (u_star <= lo + spec.tight_eps) | (u_star >= hi - spec.tight_eps)
    r = jnp.concatenate([gx, jnp.where(tight, 0.0, gu)], axis=-1)
    tau = jnp.concatenate([x_star, u_star], axis=-1)
    dx_init, dC, dc, dF, df = kkt_backward_fused(
        C, c, F, r, tau, tight, reg=spec.back_eps, interpret=True
    )
    tol = dict(rtol=3e-5, atol=3e-5)
    msg = f"seed={seed} T={T} n={n} m={m} n_tight={n_tight}"
    for got, want in ((dx_init, dx_init_r), (dc, dc_r), (dC, dC_r),
                      (df, df_r), (dF, dF_r)):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), err_msg=msg, **tol
        )


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [6, 48])
def test_fused_kkt_tiny_batch_gradient_parity(B, T):
    """The dispatch has no batch floor, so the fused KKT backward runs at
    tiny/odd B — pin gradient parity vs the XLA composite backward there
    (the kernel pads B up to a full tile; the padding rows must not
    contaminate the real gradient rows), at a short and a longer horizon."""
    rng = np.random.default_rng(820 + B + T)
    n, m = 3, 2
    C, c, F, x_star, u_star, lo, hi, gx, gu = _random_residuals(
        rng, T, B, n, m, n_tight=min(4, T * B * m // 2)
    )
    spec = LqrSpec(n_state=n, constrained=True, use_pallas=False)
    res = (x_star[0], C, c, F, jnp.zeros((T, B, n)), x_star, u_star, lo, hi)
    ref = _kkt_backward_impl(spec, res, (gx, gu))
    dx_init_r, dC_r, dc_r, dF_r, df_r = ref[:5]

    tight = (u_star <= lo + spec.tight_eps) | (u_star >= hi - spec.tight_eps)
    r = jnp.concatenate([gx, jnp.where(tight, 0.0, gu)], axis=-1)
    tau = jnp.concatenate([x_star, u_star], axis=-1)
    dx_init, dC, dc, dF, df = kkt_backward_fused(
        C, c, F, r, tau, tight, reg=spec.back_eps, interpret=True
    )
    tol = dict(rtol=3e-5, atol=3e-5)
    msg = f"B={B} T={T}"
    for got, want in ((dx_init, dx_init_r), (dc, dc_r), (dC, dC_r),
                      (df, df_r), (dF, dF_r)):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), err_msg=msg, **tol
        )


def test_fused_kkt_dispatch_through_custom_vjp(monkeypatch):
    """End to end: grads through lqr_fixed_point ride the fused kernel when
    use_pallas is forced (interpret on CPU)."""
    import diffmpc_tpu.ops.pallas.kkt as kkt_mod

    calls = {"n": 0}
    orig = kkt_mod.kkt_backward_fused

    def counting(*args, **kwargs):
        calls["n"] += 1
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(kkt_mod, "kkt_backward_fused", counting)

    rng = np.random.default_rng(810)
    T, B, n, m = 5, 520, 3, 1
    C, c, F, x_star, u_star, lo, hi, gx, gu = _random_residuals(rng, T, B, n, m)

    def loss(spec, Cv, cv):
        xs, us = lqr_fixed_point(
            spec, x_star[0], Cv, cv, F, jnp.zeros((T, B, n)),
            x_star, u_star, lo, hi,
        )
        return jnp.sum(xs * gx) + jnp.sum(us * gu)

    spec_xla = LqrSpec(n_state=n, constrained=True, use_pallas=False)
    spec_pl = LqrSpec(n_state=n, constrained=True, use_pallas=True)
    gC_ref, gc_ref = jax.grad(loss, argnums=(1, 2))(spec_xla, C, c)
    assert calls["n"] == 0
    gC_pl, gc_pl = jax.grad(loss, argnums=(1, 2))(spec_pl, C, c)
    assert calls["n"] == 1
    np.testing.assert_allclose(np.asarray(gC_pl), np.asarray(gC_ref), atol=3e-5)
    np.testing.assert_allclose(np.asarray(gc_pl), np.asarray(gc_ref), atol=3e-5)
