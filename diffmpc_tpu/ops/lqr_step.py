"""The differentiable LQR step: box-DDP forward + analytic KKT backward.

Capability parity: the reference's ``mpc/lqr_step.py`` ``LQRStep``
FunctionNode (SURVEY.md §2.1 C3, §3.2-§3.3) — the single autograd-visible op
whose forward is a Riccati backward recursion + line-searched rollout and
whose backward differentiates the fixed-point KKT conditions analytically
(O(T B (n+m)) memory, independent of solver iteration count) instead of
unrolling a tape.

Redesign: the reference implements this as a define-by-run
FunctionNode with a ``no_op_forward`` mode used to attach gradients to the
converged trajectory. Here the same split is explicit and functional:

- :func:`lqr_step` — the *solver*: Riccati (+ pnqp for box limits) and a
  vectorized line-searched rollout. Pure ``lax.scan`` code; used inside the
  iLQR loop under ``stop_gradient``.
- :func:`lqr_fixed_point` — the *derivative*: a ``jax.custom_vjp`` identity
  map on the converged trajectory whose backward solves the auxiliary
  (adjoint) LQR with tight box dimensions frozen and assembles
  ``(dx_init, dC, dc, dF, df)`` from batched outer products with the primal
  trajectory and Lagrange multipliers.

Adjoint derivation (pinned numerically by tests/test_lqr_grad.py):
for the equality-constrained QP ``min 0.5 tau'H tau + c'tau s.t. A tau = b``
with loss ``l(tau*)`` and incoming gradient ``g``, solve the auxiliary
problem ``min_p 0.5 p'H p + g'p s.t. A p = 0`` (tight control dims
additionally frozen to 0; their incoming gradient entries are zeroed).
With ``mu`` the auxiliary multiplier and ``lam`` the primal multiplier:

    grad_C_t  = 0.5 (p_t tau_t' + tau_t p_t')      grad_c_t = p_t
    grad_F_t  = -(mu_{t+1} tau_t' + lam_{t+1} p_t')
    grad_f_t  = -mu_{t+1}                          grad_x_init = -mu_0
    lam_t = -(C_t tau_t + c_t)_x + F_{t,x}' lam_{t+1}     (lam_T = 0)
    mu_t  = -(C_t p_t + r_t)_x + F_{t,x}' mu_{t+1}        (mu_T = 0)

which matches the reference's published backward up to its internal sign
conventions (SURVEY.md §3.3 note).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..utils.batch import bger, bmv, btrans, match_vma
from .lqr import (
    lqr_linesearch_rollout,
    lqr_rollout,
    riccati_backward,
)


@dataclasses.dataclass(frozen=True)
class LqrSpec:
    """Static (hashable) parameters of the differentiable LQR step."""

    n_state: int
    constrained: bool = False
    tight_eps: float = 1e-6
    back_eps: float = 1e-7
    reg: float = 1e-9
    pnqp_iter: int = 20
    linesearch_decay: float = 0.2
    max_linesearch_iter: int = 10
    delta_u: Optional[float] = None
    use_pallas: Optional[bool] = None  # None = auto (see use_kernels)
    pallas_interpret: bool = False  # kernels in interpret mode (CPU)


def _platform_name(name: str) -> str:
    name = str(name).lower()
    return "gpu" if name == "cuda" else name


def solver_platform(platform_hint: Optional[str] = None) -> str:
    """Platform of the devices in the computation being traced: an explicit
    hint (a mesh's device platform, an export target) wins; then a CPU mesh
    in the trace context (``shard_map`` over CPU devices); then the process
    default backend."""
    if platform_hint is not None:
        return _platform_name(platform_hint)
    am = jax.sharding.get_abstract_mesh()
    device = None if am.empty else getattr(am, "abstract_device", None)
    if device is not None and str(device.device_kind).lower() == "cpu":
        return "cpu"
    return _platform_name(jax.default_backend())


def use_kernels(
    use_pallas: Optional[bool],
    interpret: bool = False,
    platform_hint: Optional[str] = None,
) -> bool:
    """Whether the solve runs the Pallas kernels of ops/pallas/ — the one
    platform table:

    ========  ==========================================================
    ``gpu``   Triton kernels
    ``cpu``   XLA path; kernels only in interpret mode (``interpret``)
    other     ``ValueError``, never a quiet fallback
    ========  ==========================================================

    An explicit ``use_pallas`` overrides the auto choice on a supported
    platform (cross-lowering for CUDA from a CPU host sets it).
    """
    platform = solver_platform(platform_hint)
    if platform == "gpu":
        auto = True
    elif platform == "cpu":
        auto = interpret
    else:
        raise ValueError(
            f"no solver path for platform {platform!r}: supported are 'gpu' "
            "(Pallas Triton kernels) and 'cpu' (XLA; kernels only in "
            "interpret mode)"
        )
    return auto if use_pallas is None else use_pallas


class LqrStepResult(NamedTuple):
    xs: jnp.ndarray
    us: jnp.ndarray
    objs: jnp.ndarray
    alpha: jnp.ndarray
    improved: jnp.ndarray
    free_mask: jnp.ndarray  # (T, B, m)
    n_qp_iter: jnp.ndarray  # (T, B)


def lqr_step(
    spec: LqrSpec,
    x_init: jnp.ndarray,
    C: jnp.ndarray,
    c: jnp.ndarray,
    F: jnp.ndarray,
    f: Optional[jnp.ndarray],
    x_hat: jnp.ndarray,
    u_hat: jnp.ndarray,
    u_lower: Optional[jnp.ndarray] = None,
    u_upper: Optional[jnp.ndarray] = None,
    dynamics_fn=None,
    cost_fn=None,
) -> LqrStepResult:
    """One LQR/box-DDP step around ``(x_hat, u_hat)`` (SURVEY.md §3.2).

    Builds the delta-formulation cost around the current trajectory, runs
    the Riccati recursion (per-step pnqp when box-constrained), and rolls
    out with the vectorized backtracking line search through
    ``dynamics_fn`` (true dynamics) when given, else through ``(F, f)``.
    """
    n = spec.n_state
    tau_hat = jnp.concatenate([x_hat, u_hat], axis=-1)
    # Expand the quadratic cost about tau_hat: the delta problem keeps C and
    # gets linear term c + C tau_hat; linear-dynamics residual is zero in
    # delta form by construction.
    c_delta = c + bmv(C, tau_hat)

    res = riccati_backward(
        C,
        c_delta,
        F,
        None,
        n,
        u_lower=u_lower,
        u_upper=u_upper,
        u_hat=u_hat if u_lower is not None else None,
        reg=spec.reg,
        pnqp_iter=spec.pnqp_iter,
    )
    ls = lqr_linesearch_rollout(
        x_init,
        C,
        c,
        F,
        f,
        res.K,
        res.k,
        x_hat,
        u_hat,
        u_lower=u_lower,
        u_upper=u_upper,
        delta_u=spec.delta_u,
        dynamics_fn=dynamics_fn,
        cost_fn=cost_fn,
        decay=spec.linesearch_decay,
        max_iter=spec.max_linesearch_iter,
    )
    return LqrStepResult(
        ls.xs, ls.us, ls.objs, ls.alpha, ls.improved, res.free_mask, res.n_qp_iter
    )


# ---------------------------------------------------------------------------
# Differentiable fixed point (the reference's ``no_op_forward`` LQRStep).
# ---------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def lqr_fixed_point(
    spec: LqrSpec,
    x_init: jnp.ndarray,
    C: jnp.ndarray,
    c: jnp.ndarray,
    F: jnp.ndarray,
    f: jnp.ndarray,
    x_star: jnp.ndarray,
    u_star: jnp.ndarray,
    u_lower: jnp.ndarray,
    u_upper: jnp.ndarray,
):
    """Identity on the converged trajectory, with analytic KKT derivatives
    w.r.t. ``(x_init, C, c, F, f)`` (SURVEY.md §3.3).

    ``u_lower``/``u_upper`` must be arrays broadcastable to ``u_star`` (use
    ``+-inf`` when unconstrained and set ``spec.constrained=False``).
    """
    return x_star, u_star


def _lqr_fixed_point_fwd(spec, x_init, C, c, F, f, x_star, u_star, u_lower, u_upper):
    out = (x_star, u_star)
    return out, (x_init, C, c, F, f, x_star, u_star, u_lower, u_upper)


def _lqr_fixed_point_bwd(spec, res, grads):
    with jax.named_scope("kkt_backward"):
        return _kkt_backward_impl(spec, res, grads)


def _kkt_backward_impl(spec, res, grads):
    x_init, C, c, F, f, x_star, u_star, u_lower, u_upper = res
    gx, gu = grads
    n = spec.n_state

    if spec.constrained:
        tight = (u_star <= u_lower + spec.tight_eps) | (
            u_star >= u_upper - spec.tight_eps
        )
    else:
        tight = jnp.zeros_like(u_star, dtype=bool)
    gu = jnp.where(tight, 0.0, gu)
    r = jnp.concatenate([gx, gu], axis=-1)  # (T, B, n+m)

    # Fast path: the fused KKT kernel runs the whole backward (masked aux
    # Riccati + differential rollout + multiplier recursions + gradient
    # assembly) in one launch (ops/pallas/kkt.py).
    if use_kernels(spec.use_pallas, spec.pallas_interpret):
        from .pallas.kkt import kkt_backward_fused

        tau = jnp.concatenate([x_star, u_star], axis=-1)
        dx_init, dC, dc, dF, df = kkt_backward_fused(
            C, c, F, r, tau, tight, reg=spec.back_eps,
            interpret=spec.pallas_interpret,
        )
        zeros_like = jnp.zeros_like
        return (
            dx_init,
            dC,
            dc,
            dF,
            df,
            zeros_like(x_star),
            zeros_like(u_star),
            zeros_like(u_lower),
            zeros_like(u_upper),
        )

    # Auxiliary (adjoint) LQR: min 0.5 p'C p + r'p, A p = 0, tight dims
    # frozen. Solved by the same Riccati recursion with identity-masked
    # control dims, then a zero-residual rollout from dx_init = 0.
    aux = riccati_backward(C, r, F, None, n, ctrl_mask=tight, reg=spec.back_eps)
    p_x, p_u = lqr_rollout(jnp.zeros_like(x_init), F, None, aux.K, aux.k)
    p = jnp.concatenate([p_x, p_u], axis=-1)
    tau = jnp.concatenate([x_star, u_star], axis=-1)

    dC = 0.5 * (bger(p, tau) + bger(tau, p))
    dc = p

    Fx = F[..., :, :n]  # (T, B, n, n)

    def multiplier_scan(Ct, lin, traj):
        """lam_t = -(C_t traj_t + lin_t)_x + F_{t,x}' lam_{t+1}, lam_T = 0."""

        def step(lam_next, inp):
            Ct_, lin_, traj_, Fx_ = inp
            lam = -(bmv(Ct_, traj_) + lin_)[..., :n] + bmv(btrans(Fx_), lam_next)
            return lam, lam_next

        lam0, lam_next_seq = jax.lax.scan(
            step,
            match_vma(
                jnp.zeros(traj.shape[1:2] + (n,), dtype=traj.dtype),
                (Ct, lin, traj, Fx),
            ),
            (Ct, lin, traj, Fx),
            reverse=True,
        )
        # lam_next_seq[t] = lam_{t+1} (zero at t = T-1); lam0 = lam_0
        return lam0, lam_next_seq

    lam_0, lam_next = multiplier_scan(C, c, tau)
    mu_0, mu_next = multiplier_scan(C, r, p)

    dF = -(bger(mu_next, tau) + bger(lam_next, p))
    df = -mu_next
    dx_init = -mu_0

    zeros_like = jnp.zeros_like
    return (
        dx_init,
        dC,
        dc,
        dF,
        df,
        zeros_like(x_star),
        zeros_like(u_star),
        zeros_like(u_lower),
        zeros_like(u_upper),
    )


lqr_fixed_point.defvjp(_lqr_fixed_point_fwd, _lqr_fixed_point_bwd)
