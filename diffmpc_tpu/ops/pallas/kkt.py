"""Pallas kernel (Triton route): the fused analytic KKT backward pass.

The backward is the reason the reference exists (``mpc/lqr_step.py``
backward, SURVEY.md §3.3): differentiate the LQR fixed point analytically
instead of unrolling a tape. Round 1 fused only its Riccati sub-pass; this
kernel runs the ENTIRE backward in one launch per batch tile:

1. the auxiliary (adjoint) Riccati recursion with tight control dims frozen
   (identity-masked solves; the ``mask`` mode of :mod:`.riccati`),
2. the zero-residual differential rollout ``p`` and, in the same pass, the
   cost gradients ``dC = 1/2 (p tau' + tau p')`` and ``dc = p``,
3. the backward multiplier recursions for ``lam`` (primal) and ``mu``
   (differential) and, in the same pass, the dynamics gradients
   ``dF = -(mu_{t+1} tau_t' + lam_{t+1} p_t')``, ``df = -mu_{t+1}`` and
   ``dx_init = -mu_0``.

Between the three sweeps the gains, feedforwards and the differential
trajectory live in per-program working buffers; the equations and sign
conventions are exactly those of
:func:`diffmpc_tpu.ops.lqr_step._kkt_backward_impl`, which remains the
general XLA implementation (and the CPU path). Batch-minor entry layout as
in :mod:`.riccati`: every scalar matrix entry is a ``(tile,)`` f32 vector
over scenarios, one per GPU thread.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import riccati as _ric
from .riccati import (
    _from_kernel_layout,
    _masked_chol_solve,
    _to_kernel_layout,
    _use_exact_value_update,
    _value_update,
    launch,
    out_struct,
)


# ---------------------------------------------------------------------------
# Per-step sweep math, parameterized by entry accessors (``C(a, b)``,
# ``r(a)``: the trailing entry indices at the current step).
# ---------------------------------------------------------------------------


def _aux_ric_step(n, m, reg, C, F, r, tight, Vv):
    """One backward step of the auxiliary Riccati (tight dims frozen,
    linear term = r): returns ``(K, kt, new_Vv)`` with ``Vv`` the flattened
    ``(V, v)`` carry."""
    nm = n + m
    V = [[Vv[a * n + b] for b in range(n)] for a in range(n)]
    v = [Vv[n * n + a] for a in range(n)]
    Ft = [[F(a, b) for b in range(nm)] for a in range(n)]
    rt = [r(a) for a in range(nm)]

    W = [
        [sum(V[k][l] * Ft[l][j] for l in range(n)) for j in range(nm)]
        for k in range(n)
    ]
    Q = [[None] * nm for _ in range(nm)]
    for a in range(nm):
        for b in range(a, nm):
            val = C(a, b) + sum(Ft[k][a] * W[k][b] for k in range(n))
            Q[a][b] = val
            if b != a:
                Q[b][a] = val
    q = [rt[a] + sum(Ft[k][a] * v[k] for k in range(n)) for a in range(nm)]

    Quu = [[Q[n + a][n + b] for b in range(m)] for a in range(m)]
    Qux = [[Q[n + a][b] for b in range(n)] for a in range(m)]
    qu = [q[n + a] for a in range(m)]
    frozen = [tight(a) for a in range(m)]
    rhs_cols = [[Qux[a][b] for a in range(m)] for b in range(n)] + [qu]
    sols = _masked_chol_solve(Quu, rhs_cols, frozen, m, reg)
    K = [[-sols[b][a] for b in range(n)] for a in range(m)]
    kt = [-sols[n][a] for a in range(m)]

    # aux Riccati is mask mode — K, kt are exact masked solves, so the DDP
    # cancellation form applies whenever reg is tiny (see _value_update)
    exact_update = _use_exact_value_update("mask", m, reg)
    Vn, vn = _value_update(Q, q, Quu, qu, K, kt, n, m, exact_update)
    new_Vv = tuple(Vn[a][b] for a in range(n) for b in range(n)) + tuple(vn)
    return K, kt, new_Vv


def _diff_roll_step(n, m, K, k, F, px):
    """One forward step of the zero-residual differential rollout: returns
    ``(p, nxt)`` — the full differential state-control at this step and the
    next state carry."""
    nm = n + m
    px = list(px)
    pu = [k(a) + sum(K(a, j) * px[j] for j in range(n)) for a in range(m)]
    p = px + pu
    nxt = [sum(F(i, j) * p[j] for j in range(nm)) for i in range(n)]
    return p, nxt


def _mult_step(n, m, C, c_lin, F, r_lin, tau, p, lam_next, mu_next):
    """One backward step of both multiplier recursions
    (``lam_t = -(C tau + c)_x + Fx' lam_{t+1}``, same for ``mu`` with
    ``(p, r)``): returns ``(lam, mu)``."""
    nm = n + m
    lam = [
        -(sum(C(a, b) * tau[b] for b in range(nm)) + c_lin(a))
        + sum(F(k2, a) * lam_next[k2] for k2 in range(n))
        for a in range(n)
    ]
    mu = [
        -(sum(C(a, b) * p[b] for b in range(nm)) + r_lin(a))
        + sum(F(k2, a) * mu_next[k2] for k2 in range(n))
        for a in range(n)
    ]
    return lam, mu


def _cost_grad_entries(nm, p, tau):
    """Cost-gradient entries at one step: ``dC_t = 0.5 (p tau' + tau p')``
    as a symmetric entry grid (``dc_t`` is ``p`` itself)."""
    dC = [[None] * nm for _ in range(nm)]
    for a in range(nm):
        for b in range(a, nm):
            val = 0.5 * (p[a] * tau[b] + tau[a] * p[b])
            dC[a][b] = val
            dC[b][a] = val
    return dC


def _dyn_grad_entries(n, nm, lam_next, mu_next, tau, p):
    """Dynamics-gradient entries at one step:
    ``dF_t = -(mu_{t+1} tau' + lam_{t+1} p')``, ``df_t = -mu_{t+1}``."""
    dF = [
        [-(mu_next[i] * tau[j] + lam_next[i] * p[j]) for j in range(nm)]
        for i in range(n)
    ]
    df = [-mu_next[i] for i in range(n)]
    return dF, df


def _make_kernel(T, n, m, reg, tile):
    nm = n + m

    def kernel(
        C_ref, c_ref, F_ref, r_ref, tau_ref, tight_ref,
        dC_o, dc_o, dF_o, df_o, dx0_o,
        K_s, k_s, p_s,
    ):
        zero = jnp.zeros((tile,), jnp.float32)

        # ---- 1. auxiliary Riccati, tight dims frozen (linear term = r) ----
        def ric_body(s, Vv):
            t = T - 1 - s
            K, kt, new_Vv = _aux_ric_step(
                n, m, reg,
                lambda a, b: C_ref[t, a, b],
                lambda a, b: F_ref[t, a, b],
                lambda a: r_ref[t, a],
                lambda a: tight_ref[t, a],
                Vv,
            )
            for a in range(m):
                for b in range(n):
                    K_s[t, a, b] = K[a][b]
                k_s[t, a] = kt[a]
            return new_Vv

        jax.lax.fori_loop(0, T, ric_body, tuple(zero for _ in range(n * n + n)))

        # ---- 2. differential rollout p (f = 0, x0 = 0) + dC, dc ----
        def roll_body(t, px):
            p, nxt = _diff_roll_step(
                n, m,
                lambda a, b: K_s[t, a, b],
                lambda a: k_s[t, a],
                lambda a, b: F_ref[t, a, b],
                px,
            )
            tau = [tau_ref[t, a] for a in range(nm)]
            dC = _cost_grad_entries(nm, p, tau)
            for a in range(nm):
                p_s[t, a] = p[a]
                dc_o[t, a] = p[a]
                for b in range(nm):
                    dC_o[t, a, b] = dC[a][b]
            return tuple(nxt)

        jax.lax.fori_loop(0, T, roll_body, tuple(zero for _ in range(n)))

        # ---- 3. multipliers lam/mu (backward) + dF, df, dx_init ----
        def mult_body(s, carry):
            t = T - 1 - s
            lam_next = [carry[a] for a in range(n)]  # lam_{t+1}
            mu_next = [carry[n + a] for a in range(n)]  # mu_{t+1}
            tau = [tau_ref[t, a] for a in range(nm)]
            p = [p_s[t, a] for a in range(nm)]
            dF, df = _dyn_grad_entries(n, nm, lam_next, mu_next, tau, p)
            for i in range(n):
                df_o[t, i] = df[i]
                for j in range(nm):
                    dF_o[t, i, j] = dF[i][j]
            lam, mu = _mult_step(
                n, m,
                lambda a, b: C_ref[t, a, b],
                lambda a: c_ref[t, a],
                lambda a, b: F_ref[t, a, b],
                lambda a: r_ref[t, a],
                tau, p, lam_next, mu_next,
            )
            return tuple(lam) + tuple(mu)

        final = jax.lax.fori_loop(
            0, T, mult_body, tuple(zero for _ in range(2 * n))
        )
        for a in range(n):
            dx0_o[a] = -final[n + a]  # dx_init = -mu_0

    return kernel


def kkt_backward_fused(
    C: jnp.ndarray,
    c: jnp.ndarray,
    F: jnp.ndarray,
    r: jnp.ndarray,
    tau: jnp.ndarray,
    tight: jnp.ndarray,
    *,
    reg: float = 1e-7,
    interpret: bool = False,
):
    """Fused analytic KKT backward (SURVEY.md §3.3) for a batch of solved
    problems.

    Args match the residuals of :func:`diffmpc_tpu.ops.lqr_step.
    lqr_fixed_point`: ``C (T,B,nm,nm)``, ``c (T,B,nm)``, ``F (T,B,n,nm)``,
    ``r (T,B,nm)`` the incoming trajectory gradient with tight control dims
    already zeroed, ``tau (T,B,nm)`` the primal trajectory, ``tight
    (T,B,m)`` bool. Returns ``(dx_init, dC, dc, dF, df)``.
    """
    T, B = C.shape[0], C.shape[1]
    nm = C.shape[-1]
    m = tight.shape[-1]
    n = nm - m
    dtype = C.dtype
    tile = _ric.TILE

    orig_B = B
    pad = (-B) % tile
    if pad:
        eyepad = jnp.broadcast_to(jnp.eye(nm, dtype=dtype), (T, pad, nm, nm))
        C = jnp.concatenate([C, eyepad], axis=1)
        c = jnp.concatenate([c, jnp.zeros((T, pad, nm), dtype)], axis=1)
        F = jnp.concatenate([F, jnp.zeros((T, pad, n, nm), dtype)], axis=1)
        r = jnp.concatenate([r, jnp.zeros((T, pad, nm), dtype)], axis=1)
        tau = jnp.concatenate([tau, jnp.zeros((T, pad, nm), dtype)], axis=1)
        tight = jnp.concatenate([tight, jnp.zeros((T, pad, m), bool)], axis=1)
        B += pad
    G = B // tile

    f32 = lambda x: x.astype(jnp.float32)
    ins = [
        _to_kernel_layout(f32(C), G, tile),
        _to_kernel_layout(f32(c), G, tile),
        _to_kernel_layout(f32(F), G, tile),
        _to_kernel_layout(f32(r), G, tile),
        _to_kernel_layout(f32(tau), G, tile),
        _to_kernel_layout(tight.astype(jnp.float32), G, tile),
    ]
    out_shapes = [
        out_struct((G, T, nm, nm, tile), ins),  # dC
        out_struct((G, T, nm, tile), ins),  # dc
        out_struct((G, T, n, nm, tile), ins),  # dF
        out_struct((G, T, n, tile), ins),  # df
        out_struct((G, n, tile), ins),  # dx_init
        # working buffers
        out_struct((G, T, m, n, tile), ins),  # K
        out_struct((G, T, m, tile), ins),  # k
        out_struct((G, T, nm, tile), ins),  # p
    ]
    kernel = _make_kernel(T, n, m, reg, tile)
    dC_l, dc_l, dF_l, df_l, dx0_l = launch(
        kernel, ins, out_shapes, tile=tile, interpret=interpret
    )[:5]

    dC = _from_kernel_layout(dC_l)[:, :orig_B].astype(dtype)
    dc = _from_kernel_layout(dc_l)[:, :orig_B].astype(dtype)
    dF = _from_kernel_layout(dF_l)[:, :orig_B].astype(dtype)
    df = _from_kernel_layout(df_l)[:, :orig_B].astype(dtype)
    dx_init = _from_kernel_layout(dx0_l[:, None])[0, :orig_B].astype(dtype)
    return dx_init, dC, dc, dF, df
