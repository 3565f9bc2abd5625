"""Dynamics linearization and cost quadraticization for the iLQR loop.

Capability parity: the reference's ``mpc/mpc.py: linearize_dynamics`` /
``approximate_cost`` (SURVEY.md §3.1) with its ``GradMethods`` variants.
Under JAX, Jacobians/Hessians are exact vmapped ``jacfwd``/``hessian`` calls
compiled into the solve — there is no tape, so AUTO_DIFF costs the same as
ANALYTIC unless the model provides a cheaper closed form.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from ..types import GradMethods, LinDx
from ..utils.batch import PRECISION


def linearize_dynamics(
    dx,
    xs: jnp.ndarray,
    us: jnp.ndarray,
    method: GradMethods = GradMethods.ANALYTIC,
    fd_eps: float = 1e-4,
) -> LinDx:
    """Affine expansion of ``dx`` about a trajectory (SURVEY.md §3.1):
    ``F_t = [A_t B_t]``, ``f_t = dx(x_t, u_t) - A_t x_t - B_t u_t`` so that
    ``x_{t+1} ~= F_t tau_t + f_t``.

    ``xs: (T, B, n)``, ``us: (T, B, m)`` -> ``LinDx(F: (T, B, n, n+m),
    f: (T, B, n))``. The last time slice participates for shape uniformity
    but is unused by the solver (V_T = 0 makes it inert).
    """
    if isinstance(dx, LinDx):
        return dx

    if method in (GradMethods.ANALYTIC, GradMethods.ANALYTIC_CHECK):
        A, B = dx.grad_input(xs, us)
    elif method == GradMethods.AUTO_DIFF:
        from ..models.dynamics import Dynamics, autodiff_grad_input

        if getattr(dx, "param_batch_shape", ()):
            # per-scenario (B, P) params: the base protocol's grad_input IS
            # autodiff (jacfwd jointly mapped over (params, x, u)); closing
            # over batched params inside a per-sample vmap would broadcast
            # wrong shapes (see Dynamics.grad_input).
            A, B = Dynamics.grad_input(dx, xs, us)
        else:
            A, B = autodiff_grad_input(dx.forward, xs, us)
    elif method == GradMethods.FINITE_DIFF:
        A, B = finite_diff_grad_input(dx.forward, xs, us, eps=fd_eps)
    else:  # pragma: no cover
        raise ValueError(method)

    F = jnp.concatenate([A, B], axis=-1)
    fwd = dx.forward(xs, us)
    tau = jnp.concatenate([xs, us], axis=-1)
    f = fwd - jnp.einsum("...ij,...j->...i", F, tau, precision=PRECISION)
    return LinDx(F, f)


def finite_diff_grad_input(fwd: Callable, x, u, eps: float = 1e-4):
    """Central-difference Jacobians (ref ``GradMethods.FINITE_DIFF``),
    vectorized: one batched forward per probe dimension."""
    n = x.shape[-1]
    m = u.shape[-1]

    def probe_x(i):
        e = jnp.zeros((n,), x.dtype).at[i].set(eps)
        return (fwd(x + e, u) - fwd(x - e, u)) / (2 * eps)

    def probe_u(i):
        e = jnp.zeros((m,), u.dtype).at[i].set(eps)
        return (fwd(x, u + e) - fwd(x, u - e)) / (2 * eps)

    A = jnp.stack([probe_x(i) for i in range(n)], axis=-1)
    B = jnp.stack([probe_u(i) for i in range(m)], axis=-1)
    return A, B


def check_analytic_grads(dx, xs, us, rtol=1e-3, atol=1e-4):
    """Eager-mode ``GradMethods.ANALYTIC_CHECK``: assert the model's
    closed-form Jacobians agree with autodiff (the reference performs this
    runtime assertion inside ``linearize_dynamics``; under jit we surface it
    as an explicit host-side check)."""
    from ..models.dynamics import Dynamics, autodiff_grad_input
    import numpy as np

    A_an, B_an = dx.grad_input(xs, us)
    if getattr(dx, "param_batch_shape", ()):
        A_ad, B_ad = Dynamics.grad_input(dx, xs, us)  # batched-aware autodiff
    else:
        A_ad, B_ad = autodiff_grad_input(dx.forward, xs, us)
    np.testing.assert_allclose(
        np.asarray(A_an), np.asarray(A_ad), rtol=rtol, atol=atol,
        err_msg="analytic A (d x_next / d x) disagrees with autodiff",
    )
    np.testing.assert_allclose(
        np.asarray(B_an), np.asarray(B_ad), rtol=rtol, atol=atol,
        err_msg="analytic B (d x_next / d u) disagrees with autodiff",
    )


def quadraticize_cost(
    cost_fn: Callable, xs: jnp.ndarray, us: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Second-order expansion of a scalar cost ``cost_fn(tau) -> float`` about
    a trajectory, in the solver's absolute form: ``C_t = H(tau_t)``,
    ``c_t = g(tau_t) - H(tau_t) tau_t`` so that ``0.5 tau'C tau + c'tau``
    has the same gradient/Hessian at ``tau_t`` (ref ``approximate_cost``)."""
    tau = jnp.concatenate([xs, us], axis=-1)
    flat = tau.reshape(-1, tau.shape[-1])
    g = jax.vmap(jax.grad(cost_fn))(flat)
    H = jax.vmap(jax.hessian(cost_fn))(flat)
    T, B, nm = tau.shape
    g = g.reshape(T, B, nm)
    H = H.reshape(T, B, nm, nm)
    c = g - jnp.einsum("tbij,tbj->tbi", H, tau, precision=PRECISION)
    return H, c
