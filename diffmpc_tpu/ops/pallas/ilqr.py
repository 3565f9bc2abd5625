"""Pallas mega-kernel (Triton route): the COMPLETE box-constrained iLQR solve.

One launch runs everything the reference's ``MPC.forward`` hot path does
(SURVEY.md §3.1-§3.2). Each program owns a tile of scenarios, one per GPU
thread, in the batch-minor entry layout of :mod:`.riccati`:

- per-iteration linearization of the (entries-fusable) nonlinear dynamics —
  computed generically with in-kernel ``jax.linearize`` tangent probes of
  the env's ``entries_step`` (no per-env Jacobian code; all elementwise),
- the delta-form Riccati backward recursion with the box QP solved in
  place (shared entry helpers from :mod:`.riccati`),
- the alpha-ladder line-searched rollout through the true dynamics,
- per-scenario masked best-trajectory / convergence bookkeeping (the
  ``lax.while_loop`` semantics of :func:`diffmpc_tpu.mpc.mpc_solve`, as a
  fixed-trip-count loop with per-scenario freezing and a per-program
  early exit once every scenario of the tile is frozen).

Trajectories, gains and bookkeeping live in per-program working buffers
(extra kernel outputs that the wrapper drops); at T=512 and B=1024 they
take a few tens of MB, which stays in the card's L2 and device memory, so
one kernel serves every horizon. The XLA orchestration in
:mod:`diffmpc_tpu.mpc` remains the general implementation (callable
costs, opaque dynamics, linear dynamics) and the CPU path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from . import riccati as _ric
from .riccati import (
    _from_kernel_layout,
    _masked_chol_solve,
    _pnqp_entries,
    _to_kernel_layout,
    _use_exact_value_update,
    _value_update,
    launch,
    out_struct,
    read_kernel_params,
    stage_kernel_params,
)


class FusedSolveResult(NamedTuple):
    xs: jnp.ndarray  # (T, B, n)
    us: jnp.ndarray  # (T, B, m)
    objs: jnp.ndarray  # (B,)
    converged: jnp.ndarray  # (B,) bool
    last_improvement: jnp.ndarray  # (B,)
    alpha: jnp.ndarray  # (B,)
    n_iters: jnp.ndarray  # (B,) int32 — iLQR iterations while active
    qp_iters: jnp.ndarray  # (B,) mean pnqp iterations (last active iteration)


def _make_kernel(
    T,
    n,
    m,
    lqr_iter,
    pnqp_iter,
    reg,
    decay,
    n_alpha,
    delta_u,
    eps,
    best_cost_eps,
    not_improved_lim,
    entries_step,
    n_params,
    has_u_init,
    tile,
):
    nm = n + m
    # the mega-kernel's Riccati sweep is always box mode (degenerate boxes
    # included — u_zero_I rides it too)
    exact_update = _use_exact_value_update("box", m, reg)

    def kernel(*refs):
        i = 0
        params_ref = None
        if n_params:
            params_ref = refs[i]
            i += 1
        C_ref, c_ref, x0_ref, lo_ref, hi_ref = refs[i : i + 5]
        i += 5
        if has_u_init:
            ui_ref = refs[i]
            i += 1
        (xs_o, us_o, obj_o, conv_o, impr_o, alpha_o, iters_o, qp_o) = refs[i : i + 8]
        # working buffers (outputs the wrapper drops)
        (xh_s, uh_s, K_s, k_s, st_s) = refs[i + 8 : i + 13]
        # xs_o/us_o double as the best-trajectory buffers.
        # st_s rows: 0 cur_obj, 1 best_obj, 2 done, 3 n_not_improved,
        #            4 last_improvement, 5 last_alpha, 6 n_iters,
        #            7 mean qp iters (last active iteration)

        params = read_kernel_params(params_ref, n_params)
        zero = jnp.zeros((tile,), jnp.float32)
        one = jnp.ones((tile,), jnp.float32)

        def dyn(x, u):
            return entries_step(params, x, u)

        def dyn_lin(x, u):
            """Linearize the step once: returns the tangent map
            ``(tx, tu) -> A@tx + B@tu``. ``jax.linearize`` shares ONE
            primal trace across all nm Jacobian columns, which keeps the
            kernel program (and its compile time) small."""
            _, lin = jax.linearize(lambda xx, uu: dyn(xx, uu), x, u)
            return lin

        def stage_cost(t, x, u):
            tau = x + u
            acc = None
            for a in range(nm):
                Ctau = sum(C_ref[t, a, b] * tau[b] for b in range(nm))
                term = (0.5 * Ctau + c_ref[t, a]) * tau[a]
                acc = term if acc is None else acc + term
            return acc

        # ---- initial trajectory: warm-start controls when given (the
        # reference's u_init, clamped into the box), else zero controls ----
        def init_body(t, carry):
            obj = carry[0]
            x = list(carry[1:])
            u = [
                jnp.clip(
                    ui_ref[t, a] if has_u_init else zero,
                    lo_ref[t, a],
                    hi_ref[t, a],
                )
                for a in range(m)
            ]
            for a in range(n):
                xh_s[t, a] = x[a]
                xs_o[t, a] = x[a]
            for a in range(m):
                uh_s[t, a] = u[a]
                us_o[t, a] = u[a]
            obj = obj + stage_cost(t, x, u)
            return (obj, *dyn(x, u))

        x0 = [x0_ref[a] for a in range(n)]
        init_out = jax.lax.fori_loop(0, T, init_body, (zero, *x0))
        st_s[0] = init_out[0]  # cur_obj
        st_s[1] = init_out[0]  # best_obj
        st_s[2] = zero  # done (1.0 = frozen)
        st_s[3] = zero  # n_not_improved
        st_s[4] = jnp.full((tile,), jnp.inf, jnp.float32)
        st_s[5] = one  # last_alpha
        st_s[6] = zero  # per-scenario iLQR iteration count
        st_s[7] = zero  # mean pnqp iterations of the last active iteration

        def iteration():
            cur_obj = st_s[0]
            best_obj = st_s[1]
            done = st_s[2]
            n_not_improved = st_s[3]
            last_improvement = st_s[4]
            last_alpha = st_s[5]
            active = 1.0 - done

            # ---- Riccati backward sweep (delta form) ----
            def ric_body(s, Vv):
                t = T - 1 - s
                V = [[Vv[a * n + b] for b in range(n)] for a in range(n)]
                v = [Vv[n * n + a] for a in range(n)]
                qp_sum = Vv[n * n + n]

                # Jacobian columns via tangent probes of ONE shared
                # linearization (column j of [A B]) + the delta-form linear
                # cost ``cd = c + C tau_hat``
                xh = [xh_s[t, a] for a in range(n)]
                uh = [uh_s[t, a] for a in range(m)]
                lin = dyn_lin(xh, uh)
                Fcols = []
                for j in range(n):
                    seed = [one if a == j else zero for a in range(n)]
                    Fcols.append(lin(seed, [zero] * m))
                for j in range(m):
                    seed = [one if a == j else zero for a in range(m)]
                    Fcols.append(lin([zero] * n, seed))
                # Ft[k][j] = d x_next[k] / d tau[j]
                Ft = [[Fcols[j][k] for j in range(nm)] for k in range(n)]
                tau = xh + uh
                cd = [
                    c_ref[t, a] + sum(C_ref[t, a, b] * tau[b] for b in range(nm))
                    for a in range(nm)
                ]

                # Q = C + F' V F ; q = cd + F' v
                W = [
                    [sum(V[k][l] * Ft[l][j] for l in range(n)) for j in range(nm)]
                    for k in range(n)
                ]
                Q = [[None] * nm for _ in range(nm)]
                for a in range(nm):
                    for b in range(a, nm):
                        val = C_ref[t, a, b] + sum(
                            Ft[k][a] * W[k][b] for k in range(n)
                        )
                        Q[a][b] = val
                        if b != a:
                            Q[b][a] = val
                q = [cd[a] + sum(Ft[k][a] * v[k] for k in range(n)) for a in range(nm)]

                Quu = [[Q[n + a][n + b] for b in range(m)] for a in range(m)]
                Qux = [[Q[n + a][b] for b in range(n)] for a in range(m)]
                qu = [q[n + a] for a in range(m)]
                lo_d = [lo_ref[t, a] - uh[a] for a in range(m)]
                hi_d = [hi_ref[t, a] - uh[a] for a in range(m)]
                kt, frozen, n_qp = _pnqp_entries(Quu, qu, lo_d, hi_d, m, pnqp_iter, reg)
                qp_sum = qp_sum + n_qp
                rhs_cols = [[Qux[a][b] for a in range(m)] for b in range(n)]
                K_cols = _masked_chol_solve(Quu, rhs_cols, frozen, m, reg)
                K = [[-K_cols[b][a] for b in range(n)] for a in range(m)]

                for a in range(m):
                    for b in range(n):
                        K_s[t, a, b] = K[a][b]
                    k_s[t, a] = kt[a]

                Vn, vn = _value_update(
                    Q, q, Quu, qu, K, kt, n, m, exact_update
                )
                return (
                    tuple(Vn[a][b] for a in range(n) for b in range(n))
                    + tuple(vn)
                    + (qp_sum,)
                )

            ric_out = jax.lax.fori_loop(
                0, T, ric_body, tuple(zero for _ in range(n * n + n + 1))
            )
            st_s[7] = jnp.where(active > 0, ric_out[n * n + n] / T, st_s[7])

            # ---- line-searched rollout through the true dynamics ----
            def control(t, x, alpha):
                u = []
                for a in range(m):
                    acc = uh_s[t, a] + alpha * k_s[t, a]
                    for j in range(n):
                        acc = acc + K_s[t, a, j] * (x[j] - xh_s[t, j])
                    if delta_u is not None:
                        acc = jnp.clip(acc, uh_s[t, a] - delta_u, uh_s[t, a] + delta_u)
                    acc = jnp.clip(acc, lo_ref[t, a], hi_ref[t, a])
                    u.append(acc)
                return u

            def rollout_obj(alpha):
                def body(t, carry):
                    obj = carry[0]
                    x = list(carry[1:])
                    u = control(t, x, alpha)
                    obj = obj + stage_cost(t, x, u)
                    return (obj, *dyn(x, u))

                out = jax.lax.fori_loop(0, T, body, (zero, *x0))
                return out[0]

            # rolled ladder: alpha carried as a *= decay vector — one
            # rollout body instead of n_alpha copies; the cumulative f32
            # product drifts <= ~3e-7 relative from decay**k
            def ladder_body(_a, carry):
                alpha, chosen, has = carry
                obj_a = rollout_obj(alpha)
                improving = (obj_a < cur_obj) & (has == 0.0)
                chosen = jnp.where(improving, alpha, chosen)
                has = jnp.where(improving, 1.0, has)
                return (alpha * decay, chosen, has)

            _, chosen, has = jax.lax.fori_loop(
                0,
                n_alpha,
                ladder_body,
                (one, jnp.full((tile,), decay ** (n_alpha - 1), jnp.float32), zero),
            )

            # replay chosen mixed-alpha rollout, writing the new trajectory
            # (frozen elements keep their old one)
            def replay_body(t, carry):
                obj = carry[0]
                x = list(carry[1:])
                u = control(t, x, chosen)
                for a in range(n):
                    xh_s[t, a] = jnp.where(active > 0, x[a], xh_s[t, a])
                for a in range(m):
                    uh_s[t, a] = jnp.where(active > 0, u[a], uh_s[t, a])
                obj = obj + stage_cost(t, x, u)
                return (obj, *dyn(x, u))

            new_out = jax.lax.fori_loop(0, T, replay_body, (zero, *x0))
            new_obj = new_out[0]
            st_s[0] = jnp.where(active > 0, new_obj, cur_obj)

            improved = (new_obj < best_obj) & (active > 0)
            improved_sig = (new_obj < best_obj - best_cost_eps) & (active > 0)
            improvement = best_obj - new_obj

            # copy improved trajectories into the best buffers
            def best_body(t, carry):
                for a in range(n):
                    xs_o[t, a] = jnp.where(improved, xh_s[t, a], xs_o[t, a])
                for a in range(m):
                    us_o[t, a] = jnp.where(improved, uh_s[t, a], us_o[t, a])
                return carry

            jax.lax.fori_loop(0, T, best_body, None)
            st_s[1] = jnp.where(improved, new_obj, best_obj)
            nni = jnp.where(improved_sig, zero, n_not_improved + active)
            st_s[3] = nni
            st_s[4] = jnp.where(active > 0, improvement, last_improvement)
            st_s[5] = jnp.where(active > 0, chosen, last_alpha)
            st_s[6] = st_s[6] + active
            newly_done = (improvement < eps) | (nni >= not_improved_lim)
            st_s[2] = jnp.maximum(done, jnp.where(newly_done, 1.0, 0.0))

        # The iteration body keeps all state in the working buffers, so a
        # rolled loop keeps the program size O(1) in lqr_iter; the pl.when
        # guard skips remaining iterations once every scenario in the tile
        # is frozen (the XLA while_loop's all-done exit, per program).
        def iter_body(_i, carry):
            @pl.when(jnp.min(st_s[2]) < 0.5)
            def _():
                iteration()

            return carry

        jax.lax.fori_loop(0, lqr_iter, iter_body, None)

        obj_o[...] = st_s[1]
        conv_o[...] = jnp.where(st_s[4] < eps, 1.0, 0.0)
        impr_o[...] = st_s[4]
        alpha_o[...] = st_s[5]
        iters_o[...] = st_s[6]
        qp_o[...] = st_s[7]

    return kernel


def ilqr_solve_fused(
    x_init: jnp.ndarray,
    C: jnp.ndarray,
    c: jnp.ndarray,
    dyn,
    u_lower: jnp.ndarray,
    u_upper: jnp.ndarray,
    *,
    u_init: Optional[jnp.ndarray] = None,
    lqr_iter: int = 10,
    pnqp_iter: int = 8,
    reg: float = 1e-9,
    decay: float = 0.2,
    max_linesearch_iter: int = 10,
    delta_u: Optional[float] = None,
    eps: float = 1e-7,
    best_cost_eps: float = 1e-4,
    not_improved_lim: int = 5,
    interpret: bool = False,
) -> FusedSolveResult:
    """Full fused iLQR solve; contract mirrors the corresponding
    :func:`diffmpc_tpu.mpc.mpc_solve` configuration. ``u_init (T,B,m)``
    warm-starts the initial rollout (the reference's ``u_init``/receding-
    horizon ``prev_ctrl`` threading); None starts from zero controls.

    ``C (T,B,nm,nm)``, ``c (T,B,nm)``, bounds ``(T,B,m)``; ``dyn`` must
    provide ``kernel_params()`` and ``entries_step``.
    """
    T, B = C.shape[0], C.shape[1]
    nm = C.shape[-1]
    n = x_init.shape[-1]
    m = nm - n
    dtype = x_init.dtype
    tile = _ric.TILE

    orig_B = B
    pad = (-B) % tile
    if pad:
        C = jnp.concatenate(
            [C, jnp.broadcast_to(jnp.eye(nm, dtype=dtype), (T, pad, nm, nm))], axis=1
        )
        c = jnp.concatenate([c, jnp.zeros((T, pad, nm), dtype)], axis=1)
        x_init = jnp.concatenate([x_init, jnp.zeros((pad, n), dtype)], axis=0)
        u_lower = jnp.concatenate(
            [jnp.broadcast_to(u_lower, (T, orig_B, m)), jnp.full((T, pad, m), -1.0, dtype)],
            axis=1,
        )
        u_upper = jnp.concatenate(
            [jnp.broadcast_to(u_upper, (T, orig_B, m)), jnp.full((T, pad, m), 1.0, dtype)],
            axis=1,
        )
        if u_init is not None:
            u_init = jnp.concatenate(
                [u_init, jnp.zeros((T, pad, m), dtype)], axis=1
            )
        B += pad
    G = B // tile

    f32 = lambda x: x.astype(jnp.float32)
    params_arr, n_params, shared = stage_kernel_params(dyn, pad, G, tile)
    ins = [params_arr] if n_params else []
    ins += [
        _to_kernel_layout(f32(C), G, tile),
        _to_kernel_layout(f32(c), G, tile),
        _to_kernel_layout(f32(x_init)[None], G, tile)[:, 0],  # (G, n, tile)
        _to_kernel_layout(f32(jnp.broadcast_to(u_lower, (T, B, m))), G, tile),
        _to_kernel_layout(f32(jnp.broadcast_to(u_upper, (T, B, m))), G, tile),
    ]
    if u_init is not None:
        ins.append(_to_kernel_layout(f32(u_init), G, tile))

    out_shapes = [
        out_struct((G, T, n, tile), ins),  # xs (best)
        out_struct((G, T, m, tile), ins),  # us (best)
        out_struct((G, tile), ins),  # obj
        out_struct((G, tile), ins),  # conv
        out_struct((G, tile), ins),  # last impr
        out_struct((G, tile), ins),  # alpha
        out_struct((G, tile), ins),  # n_iters
        out_struct((G, tile), ins),  # qp_iters
        # working buffers
        out_struct((G, T, n, tile), ins),  # x_hat
        out_struct((G, T, m, tile), ins),  # u_hat
        out_struct((G, T, m, n, tile), ins),  # K
        out_struct((G, T, m, tile), ins),  # k
        out_struct((G, 8, tile), ins),  # iteration state
    ]

    kernel = _make_kernel(
        T, n, m, lqr_iter, pnqp_iter, reg, decay, max_linesearch_iter,
        delta_u, eps, best_cost_eps, not_improved_lim,
        dyn.entries_step, n_params, u_init is not None, tile,
    )
    xs_l, us_l, obj_l, conv_l, impr_l, alpha_l, iters_l, qp_l = launch(
        kernel, ins, out_shapes, tile=tile, interpret=interpret,
        n_shared=int(bool(n_params) and shared),
    )[:8]

    def per_scenario(x):  # (G, tile) -> (B,)
        return x.reshape(-1)[:orig_B]

    xs = _from_kernel_layout(xs_l)[:, :orig_B].astype(dtype)
    us = _from_kernel_layout(us_l)[:, :orig_B].astype(dtype)
    return FusedSolveResult(
        xs,
        us,
        per_scenario(obj_l).astype(dtype),
        per_scenario(conv_l) > 0.5,
        per_scenario(impr_l).astype(dtype),
        per_scenario(alpha_l).astype(dtype),
        per_scenario(iters_l).astype(jnp.int32),
        per_scenario(qp_l).astype(dtype),
    )
