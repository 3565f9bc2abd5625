"""Batched projected-Newton QP for box constraints (box-DDP inner solver).

Capability parity: the reference's ``mpc/pnqp.py`` (SURVEY.md §2.1 C2) —
solve ``min_x 0.5 x' H x + q' x  s.t. lower <= x <= upper`` for a batch of
tiny (m <= ~8) QPs, returning the solution, the Cholesky factor of the
free-subspace system (reused by the LQR step for the feedback gains), the
free mask, and an iteration count.

Redesign: every data-dependent branch of the reference (active-set
changes, per-element convergence exits, Armijo backtracking) becomes
fixed-trip-count masked computation so the whole solver lives inside one
XLA/Pallas program:

- the active ("clamped") set is a boolean mask; the free-subspace Newton
  solve is a full-size batched Cholesky of ``H`` with clamped rows/columns
  overwritten by identity and clamped gradient entries zeroed (the
  reference's own masking trick),
- converged batch elements are frozen with ``where`` instead of exiting,
- the Armijo backtracking loop is a geometric step-size ladder evaluated for
  all batch elements at once; the first strictly-improving step is taken.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..utils.batch import PRECISION, bmv, bquad, bdot, eclamp, match_vma
from .smallchol import cho_solve_small, cholesky_small


class PnqpResult(NamedTuple):
    x: jnp.ndarray  # (..., m) solution (clamped into the box)
    chol_free: jnp.ndarray  # (..., m, m) Cholesky factor of masked H
    free_mask: jnp.ndarray  # (..., m) bool, True where constraint inactive
    n_iter: jnp.ndarray  # (...,) int32, Newton iterations actually used


def masked_identity_system(
    H: jnp.ndarray, clamped: jnp.ndarray, reg: float = 0.0
) -> jnp.ndarray:
    """Overwrite clamped rows/cols of ``H`` with identity.

    With rhs entries zeroed on the clamped set, a dense solve of the masked
    system equals the free-subspace solve with zeros in clamped slots — no
    gather/scatter, fully batched (the reference's masking trick from
    ``mpc/pnqp.py``).
    """
    m = H.shape[-1]
    free = ~clamped
    keep = (free[..., :, None] & free[..., None, :]).astype(H.dtype)
    eye = jnp.eye(m, dtype=H.dtype)
    Hm = H * keep + eye * clamped[..., None, :].astype(H.dtype)
    if reg:
        Hm = Hm + reg * eye
    return Hm


def _obj(H, q, x):
    return 0.5 * bquad(x, H) + bdot(q, x)


def _pnqp_enum(H, q, lower, upper, reg, eps):
    """Exact box-QP solve by active-set enumeration (matrix-form twin of
    the fused kernel's ``_pnqp_enum_entries`` — ops/pallas/riccati.py):
    all ``3**m`` candidate active sets (each dim free / at lo / at hi) are
    solved independently via the identity-masked system, the KKT-valid
    minimum-objective candidate wins. For strictly convex ``H`` exactly one
    active set satisfies the full KKT conditions, so this IS the converged
    projected-Newton answer (tests/oracles.py ``boxqp_enumerate``), with no
    serial Newton chain. Practical only for tiny ``m``; dispatched at
    ``m == 2`` (and ``m == 3`` behind DIFFMPC_PNQP_ENUM=1) to mirror the
    Pallas kernels — keeping ``PnqpResult`` semantics (active sets, reused
    factor, ``n_iter``) identical across the XLA and fused paths."""
    import itertools

    dtype = H.dtype
    m = q.shape[-1]
    BIG = jnp.asarray(1e30, dtype)
    # KKT-validity tolerances are RELATIVE (same rationale as the kernel
    # twin): bound checks scale with the box width, gradient-sign checks
    # with |q|, so ill-scaled problems cannot reject their true active set.
    tol = 1e-6
    tol_b = tol * (1.0 + jnp.abs(upper - lower))
    tol_g = tol * (1.0 + jnp.abs(q))

    # Safety-net candidate: clipped unconstrained Newton point (always
    # finite, never BIG-masked) — selection can only improve on it.
    chol0 = cholesky_small(H, reg)
    x0 = -cho_solve_small(chol0, q[..., None])[..., 0]
    best = eclamp(x0, lower, upper)
    best_obj = _obj(H, q, best)

    for combo in itertools.product((0, 1, 2), repeat=m):
        if all(s == 0 for s in combo):
            continue  # all-free == the safety-net candidate (clipped)
        fixed = jnp.asarray([s != 0 for s in combo])
        # fixed dims pinned at their bound; free dims solve the masked
        # system with the fixed contribution moved to the rhs
        xf = jnp.where(
            jnp.asarray([s == 1 for s in combo]), lower,
            jnp.where(jnp.asarray([s == 2 for s in combo]), upper, 0.0),
        )
        Hm = masked_identity_system(H, jnp.broadcast_to(fixed, q.shape), reg)
        rhs = jnp.where(fixed, 0.0, -(q + bmv(H, xf)))
        dx = cho_solve_small(cholesky_small(Hm), rhs[..., None])[..., 0]
        x = xf + dx  # fixed rows: identity system with zero rhs -> dx = 0
        g = bmv(H, x) + q
        ok_free = (x >= lower - tol_b) & (x <= upper + tol_b)
        ok_lo = g >= -tol_g
        ok_hi = g <= tol_g
        per_dim = jnp.stack([ok_free, ok_lo, ok_hi], axis=-1)
        sel = jnp.asarray(combo)
        valid = jnp.all(
            jnp.take_along_axis(
                per_dim, jnp.broadcast_to(sel, x.shape)[..., None], axis=-1
            )[..., 0],
            axis=-1,
        )
        x = eclamp(x, lower, upper)  # accepted candidates always feasible
        o = jnp.where(valid, _obj(H, q, x), BIG)
        take = o < best_obj
        best = jnp.where(take[..., None], x, best)
        best_obj = jnp.where(take, o, best_obj)

    g = bmv(H, best) + q
    Ic = ((best <= lower + eps) & (g > 0)) | ((best >= upper - eps) & (g < 0))
    Hm = masked_identity_system(H, Ic, reg)
    return PnqpResult(
        x=best,
        chol_free=cholesky_small(Hm),
        free_mask=~Ic,
        # n_iter semantics on direct exact solves: 1 (one solve, no
        # iteration) — identical on the fused path (MPCInfo.qp_iters).
        n_iter=jnp.ones(q.shape[:-1], dtype=jnp.int32),
    )


def pnqp(
    H: jnp.ndarray,
    q: jnp.ndarray,
    lower: jnp.ndarray,
    upper: jnp.ndarray,
    x_init: Optional[jnp.ndarray] = None,
    n_iter: int = 20,
    reg: float = 1e-9,
    eps: float = 1e-6,
    armijo_decay: float = 0.5,
    armijo_iter: int = 8,
) -> PnqpResult:
    """Solve a batch of box QPs by projected Newton.

    Args:
      H: ``(..., m, m)`` symmetric positive definite Hessians.
      q: ``(..., m)`` linear terms.
      lower/upper: bounds broadcastable to ``q`` (use ``+-inf`` for
        unconstrained dims).
      x_init: optional warm start; defaults to the clamped unconstrained
        Newton point ``clamp(-H^-1 q)`` like the reference.
      n_iter: fixed Newton trip count (converged elements are frozen).
      reg: Tikhonov jitter added to the masked system before Cholesky
        (f32 stability; SURVEY.md §7 hard-part 3).
      eps: per-element convergence threshold on the Newton step.

    Returns:
      :class:`PnqpResult`; ``chol_free``/``free_mask`` correspond to the
      *final* active set so the caller (LQR backward recursion) can reuse the
      factorization for the feedback-gain solve.
    """
    dtype = H.dtype
    m = H.shape[-1]
    eye = jnp.eye(m, dtype=dtype)
    lower = jnp.broadcast_to(jnp.asarray(lower, dtype), q.shape)
    upper = jnp.broadcast_to(jnp.asarray(upper, dtype), q.shape)

    # Exact active-set enumeration at m == 2 (m == 3 behind
    # DIFFMPC_PNQP_ENUM=1), mirroring the fused kernels' dispatch
    # (ops/pallas/riccati._pnqp_entries) so solver behavior AND
    # PnqpResult.n_iter / MPCInfo.qp_iters semantics agree across the XLA
    # and Pallas paths. Lazy import: the policy
    # knobs live with the kernels (the documented monkeypatch surface,
    # CLAUDE.md), and pallas.riccati module-imports ops.lqr -> ops.pnqp,
    # so a module-level import here would cycle.
    if m in (2, 3):
        from .pallas.riccati import _pnqp_enum_mode

        enum_mode = _pnqp_enum_mode()
        if (m == 2 and enum_mode != "0") or (m == 3 and enum_mode == "1"):
            return _pnqp_enum(H, q, lower, upper, reg, eps)

    if m == 1:
        # 1-D box QP in closed form: x* = clamp(-q/H) — no Newton loop.
        # (The reference iterates here too; with one control dim the
        # projected-Newton fixed point is available directly.)
        h = H[..., 0, 0] + reg
        x = eclamp(-q[..., 0] / h, lower[..., 0], upper[..., 0])[..., None]
        g = bmv(H, x) + q
        Ic = ((x <= lower + eps) & (g > 0)) | ((x >= upper - eps) & (g < 0))
        Hm = jnp.where(Ic[..., None], 1.0, H + reg)
        return PnqpResult(
            x=x,
            chol_free=jnp.sqrt(Hm),
            free_mask=~Ic,
            n_iter=jnp.ones(q.shape[:-1], dtype=jnp.int32),
        )

    if x_init is None:
        chol0 = cholesky_small(H, reg)
        x_init = -cho_solve_small(chol0, q[..., None])[..., 0]
    x0 = eclamp(x_init, lower, upper)

    alphas = armijo_decay ** jnp.arange(armijo_iter, dtype=dtype)

    def clamped_set(x, g):
        at_lo = (x <= lower + eps) & (g > 0)
        at_hi = (x >= upper - eps) & (g < 0)
        return at_lo | at_hi

    def body(i, carry):
        x, done, iters = carry
        g = bmv(H, x) + q
        Ic = clamped_set(x, g)
        Hm = masked_identity_system(H, Ic, reg)
        gm = jnp.where(Ic, 0.0, g)
        chol = cholesky_small(Hm)
        dx = -cho_solve_small(chol, gm[..., None])[..., 0]

        step_small = jnp.max(jnp.abs(dx), axis=-1) < eps
        # Vectorized Armijo ladder: candidate points for every alpha at once.
        cand = eclamp(
            x[..., None, :] + alphas[:, None] * dx[..., None, :],
            lower[..., None, :],
            upper[..., None, :],
        )  # (..., A, m)
        obj0 = _obj(H, q, x)
        objs = 0.5 * jnp.einsum(
            "...ai,...ij,...aj->...a", cand, H, cand, precision=PRECISION
        ) + jnp.einsum("...j,...aj->...a", q, cand, precision=PRECISION)
        improved = objs < obj0[..., None]
        any_improved = jnp.any(improved, axis=-1)
        first = jnp.argmax(improved, axis=-1)  # first improving alpha
        x_new = jnp.take_along_axis(cand, first[..., None, None], axis=-2)[..., 0, :]
        x_new = jnp.where(any_improved[..., None], x_new, x)

        newly_done = step_small | ~any_improved
        x = jnp.where(done[..., None], x, x_new)
        iters = iters + jnp.where(done, 0, 1).astype(jnp.int32)
        done = done | newly_done
        return x, done, iters

    batch_shape = q.shape[:-1]
    done0 = match_vma(jnp.zeros(batch_shape, dtype=bool), (H, q, x0))
    iters0 = match_vma(jnp.zeros(batch_shape, dtype=jnp.int32), (H, q, x0))
    x, _, iters = jax.lax.fori_loop(0, n_iter, body, (x0, done0, iters0))

    # Final active set + factorization for reuse by the caller.
    g = bmv(H, x) + q
    Ic = clamped_set(x, g)
    Hm = masked_identity_system(H, Ic, reg)
    chol = cholesky_small(Hm)
    return PnqpResult(x=x, chol_free=chol, free_mask=~Ic, n_iter=iters)
