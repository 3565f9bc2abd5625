"""Batched small-matrix linear-algebra helpers.

Parity surface: the reference's ``mpc/util.py`` (SURVEY.md §2.1 C1) — ``bmv``,
``bger``, ``bquad``, ``eclamp``, ``bdiag`` and detach helpers. Under JAX most
of these are one-line ``einsum``s that XLA fuses away; they exist as named
functions so call sites read like the published algorithm and so the Pallas
kernels can swap in behind the same contract.

All functions broadcast over arbitrary leading batch dimensions.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

# All library contractions run at full f32 precision. On the GPU, XLA may
# run f32 einsum/matmul in TF32 (about three decimal digits) unless asked
# for more, which accumulates ~1e-2 relative error through the T-step
# Riccati recursion — far outside the 1e-4 parity budget (BASELINE.md). The matrices here are tiny (n+m <= ~8),
# so the correctly-rounded path costs nothing; the Pallas kernels use exact
# f32 FMAs natively.
PRECISION = jax.lax.Precision.HIGHEST


def bmv(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched matrix-vector product: ``(..., i, j), (..., j) -> (..., i)``."""
    return jnp.einsum("...ij,...j->...i", m, v, precision=PRECISION)


def bmm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched matrix-matrix product over trailing dims, full f32 precision."""
    return jnp.einsum("...ij,...jk->...ik", a, b, precision=PRECISION)


def bger(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Batched outer product: ``(..., i), (..., j) -> (..., i, j)``."""
    return jnp.einsum("...i,...j->...ij", x, y, precision=PRECISION)


def bquad(x: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Batched quadratic form ``x' M x``: ``(..., i), (..., i, i) -> (...)``."""
    return jnp.einsum("...i,...ij,...j->...", x, m, x, precision=PRECISION)


def bdot(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Batched inner product over the trailing dim."""
    return jnp.einsum("...i,...i->...", x, y, precision=PRECISION)


def bdiag(d: jnp.ndarray) -> jnp.ndarray:
    """Batched vector -> diagonal matrix: ``(..., i) -> (..., i, i)``."""
    return d[..., None, :] * jnp.eye(d.shape[-1], dtype=d.dtype)


def btrans(m: jnp.ndarray) -> jnp.ndarray:
    """Batched matrix transpose over the two trailing dims."""
    return jnp.swapaxes(m, -1, -2)


def eclamp(
    x: jnp.ndarray,
    lower: Optional[jnp.ndarray],
    upper: Optional[jnp.ndarray],
) -> jnp.ndarray:
    """Elementwise clamp with (possibly tensor-valued, possibly absent) bounds.

    The reference's ``util.eclamp`` accepts scalar or tensor bounds; ``None``
    means that side is unconstrained.
    """
    if lower is not None:
        x = jnp.maximum(x, lower)
    if upper is not None:
        x = jnp.minimum(x, upper)
    return x


def bclamp(x: jnp.ndarray, lower, upper) -> jnp.ndarray:
    """Boundary-strict clamp for env dynamics: identical VALUES to
    ``jnp.clip`` but derivative 1 at exactly the bound (``jnp.clip``'s
    tie gradient is 0.5 — ``grad(clip)(4.0) == 0.5`` — and box-DDP puts
    saturated controls EXACTLY on the bound, so autodiffed control
    Jacobians through ``clip`` are halved precisely where the box is
    active; ``PendulumDx.grad_input`` documents the strict-inequality
    convention this preserves). The solver-side ``eclamp`` keeps the
    reference's max/min form — the KKT backward handles tight dims by
    explicit masks, not clamp gradients."""
    return jnp.where(x < lower, lower, jnp.where(x > upper, upper, x))


def detach(x):
    """Cut gradients through a pytree — the reference's ``.detach()`` /
    ``get_data_maybe`` idiom becomes ``lax.stop_gradient``."""
    return jax.lax.stop_gradient(x)


def symmetrize(m: jnp.ndarray) -> jnp.ndarray:
    """0.5 (M + M') over the trailing matrix dims — keeps the Riccati value
    Hessian exactly symmetric in f32 (SURVEY.md §7 hard-part 3)."""
    return 0.5 * (m + btrans(m))


def match_vma(x, ref):
    """Promote ``x``'s varying-manual-axes type (VMA) to ``ref``'s.

    Under ``shard_map(..., check_vma=True)``, scan/while/fori carries must
    have identical VMA types on input and output; literal-initialized
    carries (``jnp.zeros(...)``) start device-invariant while body outputs
    derived from sharded inputs are batch-varying, which the checker rejects.
    This promotes the literal to match the reference operand — outside a
    manual-axes context (or when already matching) it is a no-op, so the
    solver code can use it unconditionally (SURVEY.md §5.8).

    ``ref`` may be a pytree; the union of its leaves' varying axes is used
    (a replicated cost with a sharded state must still produce a varying
    carry, because the loop body mixes both).
    """
    vma: set = set()
    for leaf in jax.tree_util.tree_leaves(ref):
        vma |= set(jax.typeof(leaf).vma)
    if not vma:
        return x
    cur = set(jax.typeof(x).vma)
    missing = tuple(sorted(vma - cur))
    if not missing:
        return x
    return jax.lax.pcast(x, missing, to="varying")
