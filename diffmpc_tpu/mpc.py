"""MPC orchestration: the iLQR outer loop around the differentiable LQR step.

Capability parity: the reference's ``mpc/mpc.py`` ``MPC`` module
(SURVEY.md §2.1 C4, §3.1) — problem configuration (the ~20 knobs of
:class:`diffmpc_tpu.types.MPCConfig`), shape expansion, per-``grad_method``
linearization, quadratic cost approximation, per-batch best-trajectory
bookkeeping, convergence/non-improvement exits, unconverged handling
(``exit_unconverged`` / ``detach_unconverged``), the slew-rate-penalty
control-augmented formulation, and fixed-point-only gradient semantics
(trajectories detached between iterations; gradients flow solely through the
final analytic-KKT LQR step).

Redesign (SURVEY.md §7 stage 6):

- the outer loop is a ``lax.while_loop`` with per-batch masked bookkeeping —
  data-dependent Python control flow (early breaks, per-element
  convergence) becomes fixed-structure masked computation;
- the whole solve is pure and jittable; ``vmap``/sharding compose around it;
- the reference's between-iteration ``detach`` is structural: the loop runs
  entirely on ``stop_gradient`` inputs, and gradients attach afterwards via
  :func:`diffmpc_tpu.ops.lqr_step.lqr_fixed_point` (the reference's
  ``no_op_forward`` LQRStep idiom);
- ``exit_unconverged`` cannot raise inside a compiled program, so the solve
  returns a per-element ``converged`` mask (plus rich per-iteration stats)
  and the eager :class:`MPC` wrapper raises on it like the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import jax
import jax.numpy as jnp

from .ops.linearize import linearize_dynamics, quadraticize_cost
from .ops.lqr import trajectory_cost
from .ops.lqr_step import LqrSpec, lqr_fixed_point, lqr_step
from .types import GradMethods, LinDx, MPCConfig, QuadCost
from .utils.batch import PRECISION, detach, match_vma

CostLike = Union[QuadCost, Callable]
DxLike = Union[LinDx, object]


class MPCInfo(NamedTuple):
    """Per-solve observability (SURVEY.md §5.5): structured stats returned
    from inside the jitted solve instead of the reference's stdout prints."""

    converged: jnp.ndarray  # (B,) bool — improvement dropped below eps
    n_iters: jnp.ndarray  # () int32 — iLQR iterations executed
    last_improvement: jnp.ndarray  # (B,)
    mean_alpha: jnp.ndarray  # (B,) line-search step of last iteration
    clamp_frac: jnp.ndarray  # (B,) fraction of clamped control dims (last it.)
    # (B,) mean inner-QP solve count over time steps (last iLQR iteration):
    # Newton iterations when the iterative pnqp dispatches (box mode at
    # m >= 3, or DIFFMPC_PNQP_ENUM=0), exactly 1.0 for direct exact solves
    # (m=1 closed form, m<=2 active-set enumeration — the default). One
    # meaning on BOTH the XLA and fused paths (pinned by
    # tests/test_quadrotor.py::test_qp_iters_semantics_agree_across_paths).
    qp_iters: jnp.ndarray
    # (B,) int32 — iLQR iterations this scenario ran before it froze
    # (n_iters is their max); the same count on both paths
    iters: jnp.ndarray


class MPCSolution(NamedTuple):
    xs: jnp.ndarray  # (T, B, n)
    us: jnp.ndarray  # (T, B, m)
    objs: jnp.ndarray  # (B,)
    info: MPCInfo


def _expand_cost(cost: QuadCost, T: int, B: int, dtype) -> QuadCost:
    """Accept the reference's flexible cost shapes (SURVEY.md §2.2):
    C of ndim 2 ``(nm, nm)``, 3 ``(T, nm, nm)`` or 4 ``(T, B, nm, nm)``;
    c of ndim 1/2/3 accordingly."""
    C, c = jnp.asarray(cost.C, dtype), jnp.asarray(cost.c, dtype)
    # Symmetrize on entry: the XLA Riccati symmetrizes Q each step while the
    # Pallas kernels mirror the upper triangle of C, so a non-symmetric user
    # C must be canonicalized here for both paths to see the same problem.
    C = 0.5 * (C + jnp.swapaxes(C, -1, -2))
    if C.ndim == 2:
        C = C[None, None]
    elif C.ndim == 3:
        C = C[:, None]
    C = jnp.broadcast_to(C, (T, B) + C.shape[-2:])
    if c.ndim == 1:
        c = c[None, None]
    elif c.ndim == 2:
        c = c[:, None]
    c = jnp.broadcast_to(c, (T, B, c.shape[-1]))
    return QuadCost(C, c)


def _expand_bound(b, T: int, B: int, m: int, dtype):
    """Accepted bound shapes (trace-time validated): scalar, ``(m,)``,
    ``(T, m)`` or ``(T, B, m)``. A 2-D array is ALWAYS read as ``(T, m)`` —
    a per-batch ``(B, m)`` bound is rejected explicitly rather than silently
    misread when ``T == B``."""
    if b is None:
        return None
    b = jnp.asarray(b, dtype)
    if b.ndim == 0:
        b = jnp.full((T, B, m), b, dtype)
    elif b.ndim == 1:
        # (1,) broadcasts unambiguously like a scalar for any n_ctrl.
        if b.shape not in ((m,), (1,)):
            raise ValueError(
                f"1-D control bound must be (n_ctrl={m},) or (1,); "
                f"got {b.shape}"
            )
        b = jnp.broadcast_to(b, (T, B, m))
    elif b.ndim == 2:
        if b.shape != (T, m):
            raise ValueError(
                f"2-D control bound is interpreted as (T={T}, n_ctrl={m}); "
                f"got {b.shape}. For per-batch bounds pass the full "
                f"(T, B, m) array."
            )
        b = jnp.broadcast_to(b[:, None, :], (T, B, m))
    elif b.ndim == 3:
        if b.shape[0] != T or b.shape[2] != m or b.shape[1] not in (1, B):
            raise ValueError(
                f"3-D control bound must broadcast to (T={T}, B={B}, "
                f"n_ctrl={m}); got {b.shape}"
            )
        b = jnp.broadcast_to(b, (T, B, m))
    else:
        raise ValueError(f"control bound has too many dims: {b.shape}")
    return b


def _expand_lin_dx(dx: LinDx, T: int, B: int, n: int, dtype) -> LinDx:
    F = jnp.asarray(dx.F, dtype)
    if F.ndim == 2:
        F = F[None, None]
    elif F.ndim == 3:
        F = F[:, None]
    F = jnp.broadcast_to(F, (T, B) + F.shape[-2:])
    if dx.f is None:
        f = jnp.zeros((T, B, n), dtype)
    else:
        f = jnp.asarray(dx.f, dtype)
        if f.ndim == 1:
            f = f[None, None]
        elif f.ndim == 2:
            f = f[:, None]
        f = jnp.broadcast_to(f, (T, B, n))
    return LinDx(F, f)


def _make_traj_cost_fn(cost_fn: Callable):
    """Lift a per-tau scalar cost to a ``(xs, us) -> (B,)`` trajectory cost."""

    def traj_cost(xs, us):
        tau = jnp.concatenate([xs, us], axis=-1)
        return jnp.sum(jax.vmap(jax.vmap(cost_fn))(tau), axis=0)

    return traj_cost


def _augment_slew(config: MPCConfig, x_init, cost, dx, u_init, u_lower, u_upper, prev_ctrl):
    """Reformulate the slew-rate penalty as a control-augmented problem
    (ref ``mpc/mpc.py`` + ``CtrlPassthroughDynamics``; SURVEY.md §2.1 C4):
    state becomes ``[u_prev; x]`` so the cost can see consecutive controls;
    the penalty ``0.5 s ||u_t - u_{t-1}||^2`` lands in the quadratic blocks
    coupling the carried control copy with the new control."""
    from .models.dynamics import CtrlPassthroughDynamics

    n, m, T = config.n_state, config.n_ctrl, config.T
    s = config.slew_rate_penalty
    B = x_init.shape[0]
    dtype = x_init.dtype
    nm = n + m
    n_aug = m + n

    if isinstance(cost, QuadCost):
        cost = _expand_cost(cost, T, B, dtype)
        C_aug = jnp.zeros((T, B, n_aug + m, n_aug + m), dtype)
        C_aug = C_aug.at[..., m : m + nm, m : m + nm].add(cost.C)
        idx_ut = jnp.arange(m)  # carried previous control
        idx_u = m + n + jnp.arange(m)  # current control
        C_aug = C_aug.at[..., idx_ut, idx_ut].add(s)
        C_aug = C_aug.at[..., idx_u, idx_u].add(s)
        C_aug = C_aug.at[..., idx_ut[:, None], idx_u[None, :]].add(-s * jnp.eye(m, dtype=dtype))
        C_aug = C_aug.at[..., idx_u[:, None], idx_ut[None, :]].add(-s * jnp.eye(m, dtype=dtype))
        c_aug = jnp.concatenate([jnp.zeros((T, B, m), dtype), cost.c], axis=-1)
        cost_aug = QuadCost(C_aug, c_aug)
    else:
        base = cost

        def cost_aug(tau):
            u_prev = tau[:m]
            u_cur = tau[m + n :]
            return base(tau[m:]) + 0.5 * s * jnp.sum((u_cur - u_prev) ** 2)

    if isinstance(dx, LinDx):
        lin = _expand_lin_dx(dx, T, B, n, dtype)
        F_aug = jnp.zeros((T, B, n_aug, n_aug + m), dtype)
        F_aug = F_aug.at[..., :m, m + n :].set(jnp.eye(m, dtype=dtype))
        F_aug = F_aug.at[..., m:, m : m + n].set(lin.F[..., :n])
        F_aug = F_aug.at[..., m:, m + n :].set(lin.F[..., n:])
        f_aug = jnp.concatenate([jnp.zeros((T, B, m), dtype), lin.f], axis=-1)
        dx_aug = LinDx(F_aug, f_aug)
    else:
        dx_aug = CtrlPassthroughDynamics(inner=dx, n_ctrl=m)

    u0 = prev_ctrl if prev_ctrl is not None else jnp.zeros((B, m), dtype)
    x_init_aug = jnp.concatenate([jnp.asarray(u0, dtype).reshape(B, m), x_init], axis=-1)

    config_aug = dataclasses.replace(
        config, n_state=n_aug, slew_rate_penalty=None
    )
    return config_aug, x_init_aug, cost_aug, dx_aug


def _would_use_fused(config, dx, *, is_quad, constrained, is_lin):
    """The single mega-kernel dispatch predicate (also used by tests to
    assert a configuration genuinely engages the fused path). There is no
    batch floor and no horizon limit: the kernel pads any B up to one
    tile and keeps its working set in device memory at any T."""
    from .ops.lqr_step import use_kernels

    return bool(
        is_quad
        and constrained
        and not is_lin
        and hasattr(dx, "entries_step")
        and hasattr(dx, "kernel_params")
        and getattr(dx, "kernel_fusable", True)
        and config.grad_method != GradMethods.FINITE_DIFF
        and config.verbose <= 0
        and use_kernels(config.use_pallas, config.pallas_interpret)
    )


def _check_param_batch(dx, B):
    """Trace-time shape check for per-scenario dynamics params. Custom
    models whose SHARED params is legitimately a 2-D array should override
    ``Dynamics.param_batch_shape`` to return ``()``."""
    pbs = getattr(dx, "param_batch_shape", ())
    if pbs and pbs != (B,):
        raise ValueError(
            f"per-scenario dynamics params must have leading batch shape "
            f"({B},) to match x_init; got {pbs}. (If this model's shared "
            f"params is intentionally 2-D, override param_batch_shape to "
            f"return ().)"
        )


def mpc_solve(
    config: MPCConfig,
    x_init: jnp.ndarray,
    cost: CostLike,
    dx: DxLike,
    u_init: Optional[jnp.ndarray] = None,
    u_lower=None,
    u_upper=None,
    prev_ctrl: Optional[jnp.ndarray] = None,
    u_zero_I=None,
) -> MPCSolution:
    """Solve a batch of (possibly nonlinear, box-constrained) MPC problems.

    Functional core of the reference's ``MPC.forward`` (SURVEY.md §3.1).
    ``config`` is static; everything else is traced. Differentiable w.r.t.
    ``x_init``, ``QuadCost`` arrays, ``LinDx`` arrays, dynamics-model
    parameters and (callable) cost closures via the analytic KKT backward.
    """
    if config.slew_rate_penalty is not None and config.slew_rate_penalty > 0:
        # validate per-scenario params HERE: the recursion below wraps dx in
        # CtrlPassthroughDynamics (no ``params`` attr), hiding the shape
        # from the check in the non-slew path
        _check_param_batch(dx, x_init.shape[0] if x_init.ndim else 0)
        m_orig = config.n_ctrl
        config_aug, x_init_aug, cost_aug, dx_aug = _augment_slew(
            config, x_init, cost, dx, u_init, u_lower, u_upper, prev_ctrl
        )
        # The control space is unchanged by the state augmentation, so
        # control-shaped knobs (u_init, bounds, u_zero_I) apply as-is.
        sol = mpc_solve(
            config_aug, x_init_aug, cost_aug, dx_aug, u_init, u_lower, u_upper,
            u_zero_I=u_zero_I,
        )
        return MPCSolution(sol.xs[..., m_orig:], sol.us, sol.objs, sol.info)

    T, n, m = config.T, config.n_state, config.n_ctrl
    if x_init.ndim != 2 or x_init.shape[-1] != n:
        raise ValueError(
            f"x_init must be (B, n_state={n}); got {x_init.shape}"
        )
    B = x_init.shape[0]
    dtype = x_init.dtype
    if isinstance(cost, QuadCost):
        nm_c = jnp.shape(cost.C)[-1]
        if nm_c != n + m:
            raise ValueError(
                f"QuadCost.C trailing dim must be n_state+n_ctrl={n + m}; "
                f"got {jnp.shape(cost.C)}"
            )
    if isinstance(dx, LinDx):
        Fs = jnp.shape(dx.F)
        if Fs[-1] != n + m or Fs[-2] != n:
            raise ValueError(
                f"LinDx.F trailing dims must be (n_state={n}, "
                f"n_state+n_ctrl={n + m}); got {Fs}"
            )
    if (u_lower is None) != (u_upper is None):
        raise ValueError("u_lower and u_upper must be both set or both None")
    _check_param_batch(dx, B)

    if u_zero_I is not None:
        # The reference's ``u_zero_I`` knob: control dims held at exactly
        # zero, expressed as the degenerate box lo = hi = 0 on those dims —
        # the box-DDP machinery (clamps, zeroed gain rows, tight-dim
        # freezing in the KKT backward) then applies unchanged.
        mask = jnp.broadcast_to(jnp.asarray(u_zero_I, bool), (T, B, m))
        big = jnp.asarray(1e18, dtype)
        base_lo = _expand_bound(u_lower, T, B, m, dtype)
        base_hi = _expand_bound(u_upper, T, B, m, dtype)
        u_lower = jnp.where(
            mask, 0.0, base_lo if base_lo is not None else jnp.full((T, B, m), -big)
        )
        u_upper = jnp.where(
            mask, 0.0, base_hi if base_hi is not None else jnp.full((T, B, m), big)
        )

    lo = _expand_bound(u_lower, T, B, m, dtype)
    hi = _expand_bound(u_upper, T, B, m, dtype)
    constrained = lo is not None

    is_lin = isinstance(dx, LinDx)
    is_quad = isinstance(cost, QuadCost)
    if is_lin:
        dx = _expand_lin_dx(dx, T, B, n, dtype)
    if is_quad:
        cost = _expand_cost(cost, T, B, dtype)

    spec = LqrSpec(
        n_state=n,
        constrained=constrained,
        tight_eps=config.tight_eps,
        back_eps=config.back_eps,
        reg=config.back_eps,
        pnqp_iter=config.pnqp_iter,
        linesearch_decay=config.linesearch_decay,
        max_linesearch_iter=config.max_linesearch_iter,
        delta_u=config.delta_u,
        use_pallas=config.use_pallas,
        pallas_interpret=config.pallas_interpret,
    )

    # ------------------------------------------------------------------
    # Non-differentiable iLQR fixed-point iteration (stop_gradient region).
    # ------------------------------------------------------------------
    x_init_sg = detach(x_init)
    # a callable cost is not a pytree of arrays; the loop outputs are
    # stop_gradient'ed regardless, so detaching is only needed for QuadCost
    cost_sg = jax.tree_util.tree_map(detach, cost) if is_quad else cost
    dx_sg = jax.tree_util.tree_map(detach, dx)
    lo_sg = detach(lo) if constrained else None
    hi_sg = detach(hi) if constrained else None

    def lin_dyn_fn(Fs, fs):
        def dyn(xt, ut, t):
            tau = jnp.concatenate([xt, ut], axis=-1)
            return jnp.einsum("bij,bj->bi", Fs[t], tau, precision=PRECISION) + fs[t]

        return dyn

    if is_lin:
        dynamics_fn = None  # rollout uses (F, f) directly — exact
        true_dynamics_step = lin_dyn_fn(dx_sg.F, dx_sg.f)
    else:
        def true_dynamics_step(xt, ut, t):
            return dx_sg.forward(xt, ut)

        dynamics_fn = true_dynamics_step

    if is_quad:
        traj_cost_fn = None
        eval_cost = lambda xs, us: trajectory_cost(cost_sg.C, cost_sg.c, xs, us)
    else:
        traj_cost_fn = _make_traj_cost_fn(cost_sg)
        eval_cost = traj_cost_fn

    # ------------------------------------------------------------------
    # Fast path: the fully-fused Pallas iLQR kernel (ops/pallas/ilqr.py)
    # covers the production shape — QuadCost + box bounds + entries-fusable
    # nonlinear dynamics, cold or warm started (u_init threads into the
    # kernel's init rollout) — running the WHOLE solve in one launch.
    # Everything else uses the general XLA orchestration below.
    # ------------------------------------------------------------------
    # Warm-start trajectory (the reference's u_init), expanded once for both
    # paths; the fused kernel threads it into its init rollout.
    if u_init is None:
        u0_warm = None
    else:
        u0_warm = detach(jnp.asarray(u_init, dtype))
        if u0_warm.ndim == 2:
            u0_warm = jnp.broadcast_to(u0_warm[:, None], (T, B, m))

    use_fused = _would_use_fused(
        config, dx_sg, is_quad=is_quad, constrained=constrained, is_lin=is_lin
    )

    if use_fused:
        from .ops.pallas.ilqr import ilqr_solve_fused

        fr = ilqr_solve_fused(
            x_init_sg,
            cost_sg.C,
            cost_sg.c,
            dx_sg,
            lo_sg,
            hi_sg,
            u_init=u0_warm,
            lqr_iter=config.lqr_iter,
            pnqp_iter=min(config.pnqp_iter, 8),
            reg=config.back_eps,
            decay=config.linesearch_decay,
            max_linesearch_iter=config.max_linesearch_iter,
            delta_u=config.delta_u,
            eps=config.eps,
            best_cost_eps=config.best_cost_eps,
            not_improved_lim=config.not_improved_lim,
            interpret=config.pallas_interpret,
        )
        best_x, best_u = detach(fr.xs), detach(fr.us)
        converged = fr.converged
        tol = jnp.asarray(config.tight_eps, dtype)
        at_bound = (best_u <= lo_sg + tol) | (best_u >= hi_sg - tol)
        # n_iters: the while_loop semantics — iterations until ALL scenarios
        # froze (the kernel reports per-scenario active counts; their max is
        # the executed iteration count).
        stats_n_iters = jnp.max(fr.n_iters)
        stats = dict(
            last_improvement=fr.last_improvement,
            alpha=fr.alpha,
            # clip for the same f32 mean-rounding reason as the XLA path's
            # update below: the stat's domain is [0, 1]
            clamp_frac=jnp.clip(
                jnp.mean(at_bound.astype(dtype), axis=(0, 2)), 0.0, 1.0
            ),
            qp_iters=fr.qp_iters,
            iters=fr.n_iters,
        )
    else:
        # Initial trajectory: roll u_init (or zeros) through the dynamics.
        u0 = jnp.zeros((T, B, m), dtype) if u0_warm is None else u0_warm
        if constrained:
            u0 = jnp.clip(u0, lo_sg, hi_sg)

        def init_rollout(us):
            def step(x, inp):
                ut, t = inp
                return true_dynamics_step(x, ut, t), x

            _, xs = jax.lax.scan(step, x_init_sg, (us, jnp.arange(T)))
            return xs

        x0 = init_rollout(u0)
        obj0 = eval_cost(x0, u0)

        def linearize_sg(xs, us):
            if is_lin:
                return dx_sg.F, dx_sg.f
            lin = linearize_dynamics(dx_sg, xs, us, config.grad_method)
            return lin.F, lin.f

        def quadraticize_sg(xs, us):
            if is_quad:
                return cost_sg.C, cost_sg.c
            return quadraticize_cost(cost_sg, xs, us)

        class Carry(NamedTuple):
            i: jnp.ndarray
            x: jnp.ndarray
            u: jnp.ndarray
            best_x: jnp.ndarray
            best_u: jnp.ndarray
            best_obj: jnp.ndarray
            n_not_improved: jnp.ndarray
            last_improvement: jnp.ndarray
            done: jnp.ndarray
            alpha: jnp.ndarray
            clamp_frac: jnp.ndarray
            qp_iters: jnp.ndarray
            iters: jnp.ndarray

        def cond(s: Carry):
            return (s.i < config.lqr_iter) & ~jnp.all(s.done)

        def body(s: Carry) -> Carry:
            F, f = linearize_sg(s.x, s.u)
            C, c = quadraticize_sg(s.x, s.u)
            out = lqr_step(
                spec,
                x_init_sg,
                C,
                c,
                F,
                f,
                s.x,
                s.u,
                u_lower=lo_sg,
                u_upper=hi_sg,
                dynamics_fn=dynamics_fn,
                cost_fn=traj_cost_fn,
            )
            # Frozen elements keep their state, best_* included (otherwise a
            # frozen element's answer would depend on whether the rest of
            # the batch keeps the loop running); active ones move to the new
            # trajectory (even if worse — best_* preserves the winner).
            act = ~s.done
            improvement = s.best_obj - out.objs
            # best tracks any strict improvement; the significance threshold
            # best_cost_eps only drives the not-improved counter (ref semantics).
            improved = act & (out.objs < s.best_obj)
            improved_sig = act & (out.objs < s.best_obj - config.best_cost_eps)
            best_obj = jnp.where(improved, out.objs, s.best_obj)
            sel = improved[None, :, None]
            best_x = jnp.where(sel, out.xs, s.best_x)
            best_u = jnp.where(sel, out.us, s.best_u)
            n_not_improved = jnp.where(improved_sig, 0, s.n_not_improved + 1)
            newly_done = (improvement < config.eps) | (
                n_not_improved >= config.not_improved_lim
            )
            sel_a = act[None, :, None]
            x = jnp.where(sel_a, out.xs, s.x)
            u = jnp.where(sel_a, out.us, s.u)
            if config.verbose > 0:
                jax.debug.print(
                    "ilqr iter {i}: mean obj {o:.6f} mean alpha {a:.3f}",
                    i=s.i,
                    o=jnp.mean(best_obj),
                    a=jnp.mean(out.alpha),
                )
            return Carry(
                i=s.i + 1,
                x=x,
                u=u,
                best_x=best_x,
                best_u=best_u,
                best_obj=best_obj,
                n_not_improved=n_not_improved,
                last_improvement=jnp.where(act, improvement, s.last_improvement),
                done=s.done | newly_done,
                alpha=jnp.where(act, out.alpha, s.alpha),
                # clip: XLA's mean is sum*(1/N) and 1/N is inexact in f32,
                # so an all-free mask otherwise reads -1.5e-8 (caught by
                # the knob-combination fuzz) — the stat's domain is [0, 1]
                clamp_frac=jnp.where(
                    act,
                    jnp.clip(
                        1.0
                        - jnp.mean(out.free_mask.astype(dtype), axis=(0, 2)),
                        0.0,
                        1.0,
                    ),
                    s.clamp_frac,
                ),
                qp_iters=jnp.where(
                    act, jnp.mean(out.n_qp_iter.astype(dtype), axis=0), s.qp_iters
                ),
                iters=s.iters + act.astype(jnp.int32),
            )

        # Literal-initialized carries are VMA-promoted against x_init so the
        # while_loop type-checks under shard_map(check_vma=True) — see
        # utils.batch.match_vma (no-op outside a manual-axes context).
        # dx_sg is always a pytree (LinDx or a dataclass Dynamics model);
        # a callable cost is not, so it is only included when QuadCost.
        vma_refs = [x_init_sg, dx_sg]
        if is_quad:
            vma_refs.append(cost_sg)
        if constrained:
            vma_refs.append((lo_sg, hi_sg))
        mv = lambda arr: match_vma(arr, vma_refs)
        init = Carry(
            # i is device-varying too: the while predicate depends on the
            # device-local done mask, so trip counts differ across devices.
            i=mv(jnp.zeros((), jnp.int32)),
            x=mv(x0),
            u=mv(u0),
            best_x=mv(x0),
            best_u=mv(u0),
            best_obj=mv(obj0),
            n_not_improved=mv(jnp.zeros((B,), jnp.int32)),
            last_improvement=mv(jnp.full((B,), jnp.inf, dtype)),
            done=mv(jnp.zeros((B,), bool)),
            alpha=mv(jnp.ones((B,), dtype)),
            clamp_frac=mv(jnp.zeros((B,), dtype)),
            qp_iters=mv(jnp.zeros((B,), dtype)),
            iters=mv(jnp.zeros((B,), jnp.int32)),
        )
        final = jax.lax.while_loop(cond, body, init)
        best_x, best_u = detach(final.best_x), detach(final.best_u)
        converged = final.last_improvement < config.eps
        stats_n_iters = final.i
        stats = dict(
            last_improvement=final.last_improvement,
            alpha=final.alpha,
            clamp_frac=final.clamp_frac,
            qp_iters=final.qp_iters,
            iters=final.iters,
        )


    # ------------------------------------------------------------------
    # Differentiable fixed-point attach (the reference's final no-op
    # LQRStep): linearize/quadraticize once more WITH gradients flowing
    # from model/cost parameters, then custom_vjp the trajectory.
    # ------------------------------------------------------------------
    if config.backprop:
        if is_lin:
            F_g, f_g = dx.F, dx.f
        else:
            lin = linearize_dynamics(dx, best_x, best_u, config.grad_method)
            F_g, f_g = lin.F, lin.f
        if is_quad:
            C_g, c_g = cost.C, cost.c
        else:
            C_g, c_g = quadraticize_cost(cost, best_x, best_u)

        big = jnp.asarray(1e18, dtype)
        lo_arr = lo if constrained else jnp.full((T, B, m), -big, dtype)
        hi_arr = hi if constrained else jnp.full((T, B, m), big, dtype)
        # Promote every custom_vjp primal to the UNION varying-manual-axes
        # type of the call before entering lqr_fixed_point: under
        # shard_map(check_vma=True) closed-over replicated operands (a
        # shared QuadCost, scalar-expanded bounds) would otherwise enter
        # the custom_vjp replicated-typed while the KKT backward's
        # cotangents — all built from the batch-varying trajectory — come
        # out varying, which strict VMA checkers reject ("bwd rule must
        # produce an output with the same type as the args tuple").
        # Promotion is also the correct semantics: the transpose of pvary
        # is a cross-device psum, exactly the reduction a replicated
        # differentiable operand needs. No-op outside a manual-axes
        # context (match_vma).
        fp_args = (x_init, C_g, c_g, F_g, f_g, best_x, best_u, lo_arr, hi_arr)
        fp_args = tuple(match_vma(a, fp_args) for a in fp_args)
        xs, us = lqr_fixed_point(spec, *fp_args)
        if config.detach_unconverged:
            keep = converged[None, :, None]
            xs = jnp.where(keep, xs, detach(xs))
            us = jnp.where(keep, us, detach(us))
    else:
        xs, us = best_x, best_u

    if is_quad:
        objs = trajectory_cost(cost.C, cost.c, xs, us)
    else:
        objs = _make_traj_cost_fn(cost)(xs, us)

    info = MPCInfo(
        converged=converged,
        n_iters=stats_n_iters,
        last_improvement=stats["last_improvement"],
        mean_alpha=stats["alpha"],
        clamp_frac=stats["clamp_frac"],
        qp_iters=stats["qp_iters"],
        iters=stats["iters"],
    )
    return MPCSolution(xs, us, objs, info)


class MPC:
    """Eager convenience wrapper mirroring the reference's ``MPC`` module
    API: ``MPC(n_state, n_ctrl, T, ...)(x_init, cost, dx) -> (x, u, objs)``
    (SURVEY.md §2.1 C4). For training loops, prefer jitting
    :func:`mpc_solve` directly (``config`` is static)."""

    def __init__(
        self,
        n_state: int,
        n_ctrl: int,
        T: int,
        u_lower=None,
        u_upper=None,
        u_init=None,
        lqr_iter: int = 10,
        grad_method: GradMethods = GradMethods.ANALYTIC,
        delta_u: Optional[float] = None,
        verbose: int = 0,
        eps: float = 1e-7,
        back_eps: float = 1e-7,
        n_batch: Optional[int] = None,
        linesearch_decay: float = 0.2,
        max_linesearch_iter: int = 10,
        exit_unconverged: bool = True,
        detach_unconverged: bool = True,
        backprop: bool = True,
        slew_rate_penalty: Optional[float] = None,
        prev_ctrl=None,
        not_improved_lim: int = 5,
        best_cost_eps: float = 1e-4,
        pnqp_iter: int = 20,
        u_zero_I=None,
    ):
        self.config = MPCConfig(
            n_state=n_state,
            n_ctrl=n_ctrl,
            T=T,
            lqr_iter=lqr_iter,
            grad_method=grad_method,
            delta_u=delta_u,
            verbose=verbose,
            eps=eps,
            back_eps=back_eps,
            linesearch_decay=linesearch_decay,
            max_linesearch_iter=max_linesearch_iter,
            exit_unconverged=exit_unconverged,
            detach_unconverged=detach_unconverged,
            backprop=backprop,
            not_improved_lim=not_improved_lim,
            best_cost_eps=best_cost_eps,
            slew_rate_penalty=slew_rate_penalty,
            pnqp_iter=pnqp_iter,
        )
        self.u_lower = u_lower
        self.u_upper = u_upper
        self.u_init = u_init
        self.prev_ctrl = prev_ctrl
        self.n_batch = n_batch
        self.u_zero_I = u_zero_I

    def solve(self, x_init, cost, dx) -> MPCSolution:
        if self.config.grad_method == GradMethods.ANALYTIC_CHECK and not isinstance(
            dx, LinDx
        ):
            from .ops.linearize import check_analytic_grads

            T, B = self.config.T, x_init.shape[0]
            u_probe = jnp.zeros((T, B, self.config.n_ctrl), x_init.dtype)
            x_probe = jnp.broadcast_to(x_init, (T,) + x_init.shape)
            check_analytic_grads(dx, x_probe, u_probe)

        sol = mpc_solve(
            self.config,
            x_init,
            cost,
            dx,
            u_init=self.u_init,
            u_lower=self.u_lower,
            u_upper=self.u_upper,
            prev_ctrl=self.prev_ctrl,
            u_zero_I=self.u_zero_I,
        )
        if self.config.exit_unconverged:
            if not bool(jnp.all(sol.info.converged)):
                n_bad = int(jnp.sum(~sol.info.converged))
                raise RuntimeError(
                    f"MPC did not converge for {n_bad} batch element(s) "
                    f"(exit_unconverged=True; pass exit_unconverged=False to "
                    f"keep best trajectories instead)"
                )
        return sol

    def __call__(self, x_init, cost, dx):
        sol = self.solve(x_init, cost, dx)
        return sol.xs, sol.us, sol.objs
