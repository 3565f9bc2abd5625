"""Batched LQR core: Riccati backward recursion + forward rollout.

Capability parity: the forward half of the reference's ``mpc/lqr_step.py``
(SURVEY.md §3.2) — a time-stepped Riccati recursion producing time-varying
feedback gains ``K_t`` / feedforward ``k_t`` (with box-DDP projected-Newton
handling of control limits), followed by a line-searched rollout.

Redesign (SURVEY.md §7 stages 2/4/5):

- the sequential-in-``t`` Python loops become ``lax.scan``s compiled by XLA;
  the whole solve is one fused program, ``vmap``-able over scenarios and
  shardable over a device mesh,
- the per-step work is tiny dense linalg of size ``n+m <= ~8`` batched over
  ``B`` — the design center for the Pallas kernels in
  :mod:`diffmpc_tpu.ops.pallas`,
- the reference's per-batch-element sequential backtracking line search is
  replaced by a vectorized alpha-ladder (same accept rule, fixed trip count),
- active-set logic is masked computation (see :mod:`diffmpc_tpu.ops.pnqp`).

Conventions (SURVEY.md §2.2): ``tau_t = [x_t; u_t]``; cost
``sum_t 0.5 tau_t' C_t tau_t + c_t' tau_t``; dynamics
``x_{t+1} = F_t tau_t + f_t`` for ``t < T-1`` (the ``t = T-1`` dynamics slice
is unused; the recursion initializes ``V_T = 0`` which makes it inert).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..utils.batch import bmm, bmv, bquad, bdot, btrans, eclamp, match_vma, symmetrize
from .pnqp import masked_identity_system, pnqp
from .smallchol import cho_solve_small, cholesky_small


class RiccatiResult(NamedTuple):
    K: jnp.ndarray  # (T, B, m, n) feedback gains
    k: jnp.ndarray  # (T, B, m) feedforward terms
    free_mask: jnp.ndarray  # (T, B, m) bool — control dims not clamped
    n_qp_iter: jnp.ndarray  # (T, B) int32 — pnqp iterations (0 when unused)


_cho_solve = cho_solve_small


def riccati_backward(
    C: jnp.ndarray,
    c: jnp.ndarray,
    F: jnp.ndarray,
    f: Optional[jnp.ndarray],
    n_state: int,
    *,
    u_lower: Optional[jnp.ndarray] = None,
    u_upper: Optional[jnp.ndarray] = None,
    u_hat: Optional[jnp.ndarray] = None,
    ctrl_mask: Optional[jnp.ndarray] = None,
    reg: float = 1e-9,
    pnqp_iter: int = 20,
    pnqp_eps: float = 1e-6,
) -> RiccatiResult:
    """Riccati backward recursion over ``t = T-1 .. 0`` (SURVEY.md §3.2).

    Three mutually exclusive constraint modes:

    - unconstrained (``u_lower is None``): plain regularized Cholesky solve
      for ``[K_t k_t] = -Q_uu^-1 [Q_ux q_u]``;
    - box (``u_lower/u_upper/u_hat`` given): per-step :func:`pnqp` in the
      delta-u formulation ``lo = u_lower - u_hat_t``, ``hi = u_upper -
      u_hat_t``; clamped gain rows are zeroed and the free-subspace Cholesky
      factor is reused for ``K_t`` (box-DDP, Tassa et al. 2014);
    - frozen dims (``ctrl_mask`` ``(T, B, m)`` bool, True = dim held at
      ``du = 0``): equality-constrained solve via identity-masking — used by
      the KKT backward pass to freeze tight box dims (SURVEY.md §3.3).

    Args:
      C: ``(T, B, n+m, n+m)``; c: ``(T, B, n+m)``; F: ``(T, B, n, n+m)``;
      f: ``(T, B, n)`` or None (treated as zeros).
    Returns:
      :class:`RiccatiResult` of per-step gains and active-set metadata.
    """
    n = n_state
    box = u_lower is not None
    if box:
        assert u_hat is not None and ctrl_mask is None
    T, B = C.shape[0], C.shape[1]
    m = C.shape[-1] - n
    dtype = C.dtype

    # Simplified (DDP-cancellation) value update, gated EXACTLY like the
    # Pallas kernels (ops/pallas/riccati._value_update — the derivation
    # and error bound live there): when the inner control solve is the
    # exact optimum of its (masked/box) QP and reg is tiny, the
    # K'Quu K / K'(qu + Quu kt) terms cancel and V' = Qxx + sym(Qxu K),
    # v' = qx + Qxu kt. Sharing the gate keeps the XLA and fused paths
    # executing the SAME math (CLAUDE.md kernel-equivalence invariant).
    # Lazy import: the gate lives with the kernels' entry math.
    from .pallas.riccati import _use_exact_value_update

    mode = "box" if box else ("mask" if ctrl_mask is not None else "free")
    exact_update = _use_exact_value_update(mode, m, reg)

    if f is None:
        f = jnp.zeros(C.shape[:2] + (n,), dtype=dtype)

    xs = dict(C=C, c=c, F=F, f=f)
    if box:
        xs["lo"] = jnp.broadcast_to(u_lower, (T, B, m)) - u_hat
        xs["hi"] = jnp.broadcast_to(u_upper, (T, B, m)) - u_hat
    if ctrl_mask is not None:
        xs["frozen"] = ctrl_mask

    def step(carry, inp):
        V, v = carry  # (B, n, n), (B, n)
        Ct, ct, Ft, ft = inp["C"], inp["c"], inp["F"], inp["f"]
        FtT = btrans(Ft)  # (B, n+m, n)
        Q = Ct + bmm(FtT, bmm(V, Ft))
        q = ct + bmv(FtT, bmv(V, ft) + v)
        Q = symmetrize(Q)

        Qxx = Q[..., :n, :n]
        Qxu = Q[..., :n, n:]
        Qux = Q[..., n:, :n]
        Quu = Q[..., n:, n:]
        qx = q[..., :n]
        qu = q[..., n:]

        if box:
            res = pnqp(
                Quu,
                qu,
                inp["lo"],
                inp["hi"],
                n_iter=pnqp_iter,
                reg=reg,
                eps=pnqp_eps,
            )
            kt = res.x
            clamped = ~res.free_mask
            Qux_m = jnp.where(clamped[..., None], 0.0, Qux)
            K = -_cho_solve(res.chol_free, Qux_m)
            free = res.free_mask
            qp_iters = res.n_iter
        elif ctrl_mask is not None:
            frozen = inp["frozen"]
            Hm = masked_identity_system(Quu, frozen, reg)
            chol = cholesky_small(Hm)
            rhs = jnp.concatenate(
                [
                    jnp.where(frozen[..., None], 0.0, Qux),
                    jnp.where(frozen, 0.0, qu)[..., None],
                ],
                axis=-1,
            )
            Kk = -_cho_solve(chol, rhs)
            K, kt = Kk[..., :n], Kk[..., n]
            free = ~frozen
            qp_iters = jnp.zeros(qu.shape[:-1], dtype=jnp.int32)
        else:
            chol = cholesky_small(Quu, reg)
            rhs = jnp.concatenate([Qux, qu[..., None]], axis=-1)
            Kk = -_cho_solve(chol, rhs)
            K, kt = Kk[..., :n], Kk[..., n]
            free = jnp.ones(qu.shape, dtype=bool)
            qp_iters = jnp.zeros(qu.shape[:-1], dtype=jnp.int32)

        if exact_update:
            QxuK = bmm(Qxu, K)
            V_new = Qxx + 0.5 * (QxuK + btrans(QxuK))
            v_new = qx + bmv(Qxu, kt)
        else:
            KT = btrans(K)
            V_new = Qxx + bmm(Qxu, K) + bmm(KT, Qux) + bmm(KT, bmm(Quu, K))
            v_new = qx + bmv(Qxu, kt) + bmv(KT, qu + bmv(Quu, kt))
        V_new = symmetrize(V_new)
        return (V_new, v_new), dict(K=K, k=kt, free=free, qp=qp_iters)

    V0 = match_vma(jnp.zeros((B, n, n), dtype=dtype), (C, c, F))
    v0 = match_vma(jnp.zeros((B, n), dtype=dtype), (C, c, F))
    with jax.named_scope("riccati_backward"):
        _, out = jax.lax.scan(step, (V0, v0), xs, reverse=True)
    return RiccatiResult(out["K"], out["k"], out["free"], out["qp"])


def lqr_rollout(
    x_init: jnp.ndarray,
    F: jnp.ndarray,
    f: Optional[jnp.ndarray],
    K: jnp.ndarray,
    k: jnp.ndarray,
    x_hat: Optional[jnp.ndarray] = None,
    u_hat: Optional[jnp.ndarray] = None,
    alpha=1.0,
    u_lower: Optional[jnp.ndarray] = None,
    u_upper: Optional[jnp.ndarray] = None,
    delta_u: Optional[float] = None,
    dynamics_fn: Optional[Callable] = None,
):
    """Forward rollout with time-varying affine policy (SURVEY.md §3.2).

    ``u_t = u_hat_t + alpha * k_t + K_t (x_t - x_hat_t)``, then (optionally)
    the delta-u trust-region clamp to ``u_hat_t +- delta_u``, then the box
    clamp; the state advances through ``dynamics_fn(x, u, t)`` if given
    (true nonlinear dynamics, as the reference's ``lqr_forward`` does inside
    iLQR) else through the affine model ``F_t tau_t + f_t``.

    ``x_hat``/``u_hat`` default to zeros (pure LQR policy rollout). ``alpha``
    may be scalar or per-batch ``(B,)``.

    Returns ``(xs, us)`` with ``xs: (T, B, n)`` (``xs[0] = x_init``) and
    ``us: (T, B, m)``.
    """
    T, B, mm = K.shape[0], K.shape[1], K.shape[2]
    dtype = x_init.dtype
    if x_hat is None:
        x_hat = jnp.zeros((T, B, x_init.shape[-1]), dtype=dtype)
    if u_hat is None:
        u_hat = jnp.zeros((T, B, mm), dtype=dtype)
    if f is None:
        f = jnp.zeros((T, B, x_init.shape[-1]), dtype=dtype)
    alpha = jnp.asarray(alpha, dtype=dtype)
    if alpha.ndim == 1:
        alpha = alpha[:, None]  # (B, 1) broadcasting over control dim

    ts = jnp.arange(T)

    def step(x, inp):
        t, Ft, ft, Kt, kt, xh, uh, lo, hi = inp
        u = uh + alpha * kt + bmv(Kt, x - xh)
        if delta_u is not None:
            u = eclamp(u, uh - delta_u, uh + delta_u)
        if lo is not None:
            u = eclamp(u, lo, hi)
        tau = jnp.concatenate([x, u], axis=-1)
        if dynamics_fn is not None:
            x_next = dynamics_fn(x, u, t)
        else:
            x_next = bmv(Ft, tau) + ft
        return x_next, (x, u)

    if u_lower is None:
        # Keep the scan signature uniform: bounds as +-inf arrays are avoided
        # to skip two clamps entirely when unconstrained.
        def step_unc(x, inp):
            t, Ft, ft, Kt, kt, xh, uh = inp
            u = uh + alpha * kt + bmv(Kt, x - xh)
            if delta_u is not None:
                u = eclamp(u, uh - delta_u, uh + delta_u)
            tau = jnp.concatenate([x, u], axis=-1)
            x_next = dynamics_fn(x, u, t) if dynamics_fn is not None else bmv(Ft, tau) + ft
            return x_next, (x, u)

        _, (xs, us) = jax.lax.scan(step_unc, x_init, (ts, F, f, K, k, x_hat, u_hat))
    else:
        lo_seq = jnp.broadcast_to(u_lower, (T, B, mm))
        hi_seq = jnp.broadcast_to(u_upper, (T, B, mm))
        _, (xs, us) = jax.lax.scan(
            step, x_init, (ts, F, f, K, k, x_hat, u_hat, lo_seq, hi_seq)
        )
    return xs, us


def trajectory_cost(C: jnp.ndarray, c: jnp.ndarray, xs: jnp.ndarray, us: jnp.ndarray):
    """Total quadratic cost per batch element: ``(B,)``."""
    tau = jnp.concatenate([xs, us], axis=-1)
    return jnp.sum(0.5 * bquad(tau, C) + bdot(c, tau), axis=0)


class LineSearchResult(NamedTuple):
    xs: jnp.ndarray  # (T, B, n)
    us: jnp.ndarray  # (T, B, m)
    objs: jnp.ndarray  # (B,) accepted trajectory cost
    alpha: jnp.ndarray  # (B,) accepted step size
    improved: jnp.ndarray  # (B,) bool — strict improvement over (x_hat, u_hat)


def lqr_linesearch_rollout(
    x_init: jnp.ndarray,
    C: jnp.ndarray,
    c: jnp.ndarray,
    F: jnp.ndarray,
    f: Optional[jnp.ndarray],
    K: jnp.ndarray,
    k: jnp.ndarray,
    x_hat: jnp.ndarray,
    u_hat: jnp.ndarray,
    *,
    u_lower: Optional[jnp.ndarray] = None,
    u_upper: Optional[jnp.ndarray] = None,
    delta_u: Optional[float] = None,
    dynamics_fn: Optional[Callable] = None,
    cost_fn: Optional[Callable] = None,
    decay: float = 0.2,
    max_iter: int = 10,
) -> LineSearchResult:
    """Vectorized backtracking line search (SURVEY.md §7 stage 5).

    The reference backtracks each batch element independently
    (``lqr_step.py: lqr_forward``: halve alpha until the true cost decreases,
    up to ``max_linesearch_iter`` times). Here the full geometric ladder
    ``alpha_j = decay**j`` is evaluated for all elements in one batched
    rollout (the ladder is folded into the batch axis), and each element takes the first strictly-improving
    step, falling back to the smallest alpha exactly like an exhausted
    backtracking loop.

    ``cost_fn(xs, us) -> (B,)`` overrides the quadratic trajectory cost (the
    reference uses the true cost module when one is supplied).
    """
    dtype = x_init.dtype
    alphas = jnp.asarray(decay, dtype) ** jnp.arange(max_iter, dtype=dtype)

    def roll(alpha):
        return lqr_rollout(
            x_init,
            F,
            f,
            K,
            k,
            x_hat,
            u_hat,
            alpha=alpha,
            u_lower=u_lower,
            u_upper=u_upper,
            delta_u=delta_u,
            dynamics_fn=dynamics_fn,
        )

    xs_l, us_l = jax.vmap(roll)(alphas)  # (A, T, B, n), (A, T, B, m)
    if cost_fn is None:
        objs_l = jax.vmap(lambda xs, us: trajectory_cost(C, c, xs, us))(xs_l, us_l)
        obj0 = (
            trajectory_cost(C, c, x_hat, u_hat)
            if cost_fn is None
            else cost_fn(x_hat, u_hat)
        )
    else:
        objs_l = jax.vmap(cost_fn)(xs_l, us_l)
        obj0 = cost_fn(x_hat, u_hat)

    improved_l = objs_l < obj0[None, :]  # (A, B)
    any_improved = jnp.any(improved_l, axis=0)
    first = jnp.argmax(improved_l, axis=0)  # first (largest) improving alpha
    idx = jnp.where(any_improved, first, max_iter - 1)  # else smallest alpha

    take = lambda arr: jnp.take_along_axis(
        arr, idx[None, None, :, None], axis=0
    )[0]
    xs = take(xs_l)
    us = take(us_l)
    objs = jnp.take_along_axis(objs_l, idx[None, :], axis=0)[0]
    alpha = alphas[idx]
    return LineSearchResult(xs, us, objs, alpha, any_improved)
