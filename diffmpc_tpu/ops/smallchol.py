"""Unrolled batched Cholesky for tiny SPD systems (m <= ~8).

The solver's per-timestep systems are ``(n+m) <= ~8`` (SURVEY.md §3.2
"per-t work is tiny dense linalg"). XLA's generic ``cholesky`` /
``triangular_solve`` lower to blocked algorithms with per-op overhead that
dwarfs the arithmetic at this size; unrolling the factorization into scalar
vector ops over the batch (everything becomes length-B elementwise work)
is the accelerator-friendly shape and is also what the Pallas kernels
inline.

All functions broadcast over arbitrary leading batch dims; the matrix dim
must be static.
"""

from __future__ import annotations

import jax.numpy as jnp


def cholesky_small(A: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Lower Cholesky factor of ``A (..., m, m)`` via the unrolled
    Cholesky-Crout recurrence (static Python loops over m, batched vector
    arithmetic over everything else)."""
    m = A.shape[-1]
    if jitter:
        A = A + jitter * jnp.eye(m, dtype=A.dtype)
    if m == 1:
        return jnp.sqrt(A)
    cols = [[None] * m for _ in range(m)]  # cols[i][j] = L[..., i, j]
    for j in range(m):
        s = A[..., j, j]
        for k in range(j):
            s = s - cols[j][k] * cols[j][k]
        d = jnp.sqrt(s)
        cols[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, m):
            s = A[..., i, j]
            for k in range(j):
                s = s - cols[i][k] * cols[j][k]
            cols[i][j] = s * inv_d
    rows = [
        jnp.stack(
            [cols[i][j] if j <= i else jnp.zeros_like(A[..., 0, 0]) for j in range(m)],
            axis=-1,
        )
        for i in range(m)
    ]
    return jnp.stack(rows, axis=-2)


def solve_tril_small(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve ``L y = b`` (unrolled forward substitution).
    ``L (..., m, m)`` lower-triangular, ``b (..., m, k)``."""
    m = L.shape[-1]
    ys = []
    for i in range(m):
        s = b[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * ys[k]
        ys.append(s / L[..., i, i, None])
    return jnp.stack(ys, axis=-2)


def solve_triu_small(L: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Solve ``L' x = y`` with lower-triangular ``L`` (unrolled back
    substitution)."""
    m = L.shape[-1]
    xs = [None] * m
    for i in reversed(range(m)):
        s = y[..., i, :]
        for k in range(i + 1, m):
            s = s - L[..., k, i, None] * xs[k]
        xs[i] = s / L[..., i, i, None]
    return jnp.stack(xs, axis=-2)


def cho_solve_small(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve ``A x = b`` given ``L = cholesky_small(A)``; ``b (..., m, k)``."""
    if L.shape[-1] == 1:
        return b / (L * L)
    return solve_triu_small(L, solve_tril_small(L, b))


def solve_psd_small(A: jnp.ndarray, b: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Solve the SPD system ``A x = b`` for tiny static ``m``;
    ``b (..., m, k)``."""
    if A.shape[-1] == 1:
        if jitter:
            A = A + jitter
        return b / A
    return cho_solve_small(cholesky_small(A, jitter), b)


def solve_general_small(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve a general (non-symmetric) tiny system ``A x = b`` by unrolled
    Gaussian elimination WITHOUT pivoting; ``b (..., m, k)``.

    Intended for well-conditioned matrices with dominant diagonal — e.g. the
    ``I + C J`` combiners of the parallel-in-time Riccati scan, whose
    eigenvalues are >= 1 (C, J PSD). Not safe for arbitrary matrices.
    """
    m = A.shape[-1]
    if m == 1:
        return b / A
    # rows of the augmented system [A | b]
    rows = [
        jnp.concatenate([A[..., i, :], b[..., i, :]], axis=-1) for i in range(m)
    ]
    for j in range(m):
        piv = rows[j][..., j : j + 1]
        rows[j] = rows[j] / piv
        for i in range(m):
            if i != j:
                rows[i] = rows[i] - rows[i][..., j : j + 1] * rows[j]
    return jnp.stack([rows[i][..., m:] for i in range(m)], axis=-2)
