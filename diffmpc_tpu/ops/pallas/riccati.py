"""Shared pieces of the Pallas kernels (Triton route, one GPU thread per
scenario).

The solver's hot loop is per-timestep dense linear algebra of size
``n+m <= ~8`` batched over thousands of scenarios. That is too small for
the tensor cores or a BLAS call, so the kernels do the opposite: they
scalarize the tiny matrices and vectorize over scenarios. Every matrix
entry is a ``(W,)`` f32 vector holding one value per scenario of the
program's tile (batch-minor layout), and every matrix operation is
unrolled into elementwise arithmetic on those vectors. With
``num_warps = W / 32`` each GPU thread owns exactly one scenario, so a
thread only ever reads back trajectory entries it wrote itself.

This module holds what the mega-kernel (:mod:`.ilqr`) and the KKT
backward (:mod:`.kkt`) share: the entry-wise Cholesky, box-QP and
value-update helpers, the batch-minor layout transforms, the dynamics
parameter staging, and the one ``pallas_call`` launch both kernels use.
"""

from __future__ import annotations

import os as _os

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Scenarios per program, one per thread. A power of two (Triton tensor
# sizes must be) and a multiple of the 32-thread warp.
TILE = 32


# ---------------------------------------------------------------------------
# Entry-wise linear algebra on lists of per-scenario vectors (generated with
# static Python loops — the in-kernel counterpart of ops/smallchol.py).
# ---------------------------------------------------------------------------


def _chol_entries(A, m, reg=0.0):
    """Cholesky of an m x m SPD matrix whose entries A[i][j] are
    per-scenario vectors; returns lower-factor entries."""
    L = [[None] * m for _ in range(m)]
    for j in range(m):
        s = A[j][j] + reg if reg else A[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(s)
        L[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, m):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    return L


def _cho_solve_entries(L, b, m):
    """Solve A x = b with L the Cholesky entries; b is a list of m tiles."""
    y = [None] * m
    for i in range(m):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * m
    for i in reversed(range(m)):
        s = y[i]
        for k in range(i + 1, m):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _masked_chol_solve(Quu, rhs_cols, frozen, m, reg):
    """Solve (masked Quu) X = rhs for several rhs columns with frozen dims
    replaced by identity rows/cols and rhs rows zeroed — the shared
    machinery of box/mask modes (see ops/pnqp.py masked_identity_system)."""
    free = [1.0 - frozen[i] for i in range(m)]
    if m == 1:
        # scalar system: one reciprocal instead of sqrt + two divides per
        # column; agrees with the Cholesky path to f32 roundoff (~1e-6 on
        # gains).
        inv = 1.0 / (Quu[0][0] * free[0] + frozen[0] + reg)
        return [[col[0] * free[0] * inv] for col in rhs_cols]
    Am = [
        [
            Quu[i][j] * free[i] * free[j] + (frozen[i] if i == j else 0.0)
            for j in range(m)
        ]
        for i in range(m)
    ]
    L = _chol_entries(Am, m, reg)
    outs = []
    for col in rhs_cols:
        col_m = [col[i] * free[i] for i in range(m)]
        outs.append(_cho_solve_entries(L, col_m, m))
    return outs


def _pnqp_enum_entries(Quu, qu, lo, hi, m, reg):
    """Exact box-QP solve by active-set enumeration in the entry-tile
    layout: all ``3**m`` candidate active sets (each control dim free /
    at lo / at hi) are solved INDEPENDENTLY — data-parallel work with
    no serial Newton chain — then the KKT-valid minimum-objective candidate
    is selected with a short ``where`` chain.

    For strictly convex ``Quu`` the box QP has a unique optimum and exactly
    one active set satisfies the full KKT conditions, so this agrees with
    the converged projected-Newton iteration (it IS the oracle construction
    tests/oracles.py uses). Practical only for tiny ``m`` (3**m candidate
    solves); dispatched for ``m == 2``, where it replaces the serial
    Newton chain of the quadrotor's Riccati step."""
    import itertools

    BIG = jnp.float32(1e30)
    # KKT-validity tolerances are RELATIVE (round 4, advisor finding): on
    # ill-scaled problems (|Quu|,|qu| >> 1) f32 roundoff exceeds any
    # absolute slop and the true active set would be rejected — silently
    # falling back to the clipped-Newton safety net while _pnqp_is_exact
    # still reports the solve exact. Bound checks scale with the box width,
    # gradient-sign checks with the gradient's natural magnitude |qu|.
    # Ties resolve by objective and tied candidates carry near-identical x.
    tol = 1e-6
    tol_b = [tol * (1.0 + jnp.abs(hi[i] - lo[i])) for i in range(m)]
    tol_g = [tol * (1.0 + jnp.abs(qu[i])) for i in range(m)]

    def obj(xv):
        return sum(
            0.5 * xv[i] * sum(Quu[i][j] * xv[j] for j in range(m))
            + qu[i] * xv[i]
            for i in range(m)
        )

    # Safety-net initial candidate: clipped unconstrained Newton point
    # (always finite, never BIG-masked) — selection can only improve on it.
    L0 = _chol_entries(Quu, m, reg)
    x0 = _cho_solve_entries(L0, [-qu[i] for i in range(m)], m)
    best = [jnp.clip(x0[i], lo[i], hi[i]) for i in range(m)]
    best_obj = obj(best)

    for combo in itertools.product((0, 1, 2), repeat=m):
        free_idx = [i for i, s in enumerate(combo) if s == 0]
        if len(free_idx) == m:
            continue  # all-free == the safety-net candidate (clipped)
        fixed = {
            i: (lo[i] if s == 1 else hi[i])
            for i, s in enumerate(combo)
            if s != 0
        }
        x = [None] * m
        for i, xv in fixed.items():
            x[i] = xv
        if free_idx:
            A = [[Quu[i][j] for j in free_idx] for i in free_idx]
            b = [
                -(qu[i] + sum(Quu[i][j] * fixed[j] for j in fixed))
                for i in free_idx
            ]
            L = _chol_entries(A, len(free_idx), reg)
            sol = _cho_solve_entries(L, b, len(free_idx))
            for k, i in enumerate(free_idx):
                x[i] = sol[k]
        g = [
            sum(Quu[i][j] * x[j] for j in range(m)) + qu[i] for i in range(m)
        ]
        valid = None
        for i, s in enumerate(combo):
            if s == 0:
                ok = (x[i] >= lo[i] - tol_b[i]) & (x[i] <= hi[i] + tol_b[i])
            elif s == 1:
                ok = g[i] >= -tol_g[i]
            else:
                ok = g[i] <= tol_g[i]
            valid = ok if valid is None else (valid & ok)
        # clip free dims so an accepted candidate is always feasible
        x = [jnp.clip(x[i], lo[i], hi[i]) for i in range(m)]
        o = jnp.where(valid, obj(x), BIG)
        take = o < best_obj
        best = [jnp.where(take, x[i], best[i]) for i in range(m)]
        best_obj = jnp.where(take, o, best_obj)

    g = [
        sum(Quu[i][j] * best[j] for j in range(m)) + qu[i] for i in range(m)
    ]
    frozen = [
        jnp.where(
            ((best[i] <= lo[i] + 1e-6) & (g[i] > 0))
            | ((best[i] >= hi[i] - 1e-6) & (g[i] < 0)),
            1.0,
            0.0,
        )
        for i in range(m)
    ]
    return best, frozen, jnp.ones_like(best[0])


# DIFFMPC_PNQP_ENUM: "" (default) = enumeration at m == 2; "0" = always the
# projected-Newton loop (A/B knob); "1" = extend enumeration to m == 3
# (27 candidates — op count grows past the loop's, chain still shorter).
# At m=3 the enumeration is exact — it matches the f64 brute-force oracle
# to 5e-8 objective on 4096 corner-heavy QPs where the loop's rare corner
# picks are equal-objective near-ties (DESIGN.md §3a). Left opt-in (not
# the default like m=2) because no m=3 env shape exists in the zoo.
#
# The env var is consulted at DISPATCH time (an import-time read would
# silently ignore env flips made after `import diffmpc_tpu`); the module
# global `_PNQP_ENUM` is the in-process default tests/A-Bs monkeypatch when
# the env var is unset. Either way the knob is read at TRACE time — already
# jit-compiled programs (cached on shapes only) do not see later flips;
# retrace (fresh jit / cache-missing shapes) to apply one.
_PNQP_ENUM = _os.environ.get("DIFFMPC_PNQP_ENUM", "")


def _pnqp_enum_mode() -> str:
    """The effective DIFFMPC_PNQP_ENUM value: the live env var when set,
    else the monkeypatchable module default."""
    env = _os.environ.get("DIFFMPC_PNQP_ENUM")
    return env if env is not None else _PNQP_ENUM


def _pnqp_entries(Quu, qu, lo, hi, m, n_iter, reg):
    """In-kernel batched projected-Newton box QP in the entry-tile layout —
    the fused counterpart of ops/pnqp.py (same masking trick, fixed trip
    count with per-scenario freezing, first-improving-step Armijo ladder).

    Returns ``(x, frozen, n_qp)`` where ``n_qp`` is the per-scenario count of
    Newton iterations actually used (ops/pnqp.py ``PnqpResult.n_iter``
    semantics — truthful solver stats on the Pallas path too). m == 1 uses
    the exact scalar closed form; m == 2 the exact active-set enumeration
    (``n_qp = 1`` for both: direct solves, no iteration)."""
    enum_mode = _pnqp_enum_mode()
    if (m == 2 and enum_mode != "0") or (m == 3 and enum_mode == "1"):
        return _pnqp_enum_entries(Quu, qu, lo, hi, m, reg)
    if m == 1:
        h = Quu[0][0] + reg
        x = jnp.clip(-qu[0] / h, lo[0], hi[0])
        g = Quu[0][0] * x + qu[0]
        # same 1e-6 boundary tolerance as the XLA pnqp (ops/pnqp.py) and the
        # m > 1 branch below, so near-boundary active sets agree across paths
        clamped = jnp.where(
            ((x <= lo[0] + 1e-6) & (g > 0)) | ((x >= hi[0] - 1e-6) & (g < 0)),
            1.0,
            0.0,
        )
        return [x], [clamped], jnp.ones_like(x)

    # start from the clamped unconstrained Newton point
    L0 = _chol_entries(Quu, m, reg)
    x = _cho_solve_entries(L0, [-qu[i] for i in range(m)], m)
    x = [jnp.clip(x[i], lo[i], hi[i]) for i in range(m)]

    def matvec(M, v):
        return [sum(M[i][j] * v[j] for j in range(m)) for i in range(m)]

    def obj(xv):
        Hx = matvec(Quu, xv)
        return sum(0.5 * xv[i] * Hx[i] + qu[i] * xv[i] for i in range(m))

    frozen = None
    done = jnp.zeros_like(x[0])
    n_qp = jnp.zeros_like(x[0])
    for _ in range(n_iter):
        g = [matvec(Quu, x)[i] + qu[i] for i in range(m)]
        frozen = [
            jnp.where(
                ((x[i] <= lo[i] + 1e-6) & (g[i] > 0))
                | ((x[i] >= hi[i] - 1e-6) & (g[i] < 0)),
                1.0,
                0.0,
            )
            for i in range(m)
        ]
        (dx,) = _masked_chol_solve(Quu, [[-g[i] for i in range(m)]], frozen, m, reg)
        step_small = jnp.where(
            sum(jnp.maximum(jnp.abs(dx[i]) - 1e-6, 0.0) for i in range(m)) == 0.0,
            1.0,
            0.0,
        )
        f0 = obj(x)
        best = x
        accepted = jnp.zeros_like(f0)
        alpha = 1.0
        for _a in range(6):
            cand = [
                jnp.clip(x[i] + alpha * dx[i], lo[i], hi[i]) for i in range(m)
            ]
            better = (obj(cand) < f0) & (accepted == 0.0)
            best = [jnp.where(better, cand[i], best[i]) for i in range(m)]
            accepted = jnp.where(better, 1.0, accepted)
            alpha *= 0.5
        # freeze converged scenarios (XLA pnqp parity: done elements keep x;
        # n_qp counts iterations while active)
        x = [jnp.where(done > 0, x[i], best[i]) for i in range(m)]
        n_qp = n_qp + (1.0 - done)
        newly_done = jnp.maximum(step_small, 1.0 - accepted)
        done = jnp.maximum(done, newly_done)

    g = [sum(Quu[i][j] * x[j] for j in range(m)) + qu[i] for i in range(m)]
    frozen = [
        jnp.where(
            ((x[i] <= lo[i] + 1e-6) & (g[i] > 0))
            | ((x[i] >= hi[i] - 1e-6) & (g[i] < 0)),
            1.0,
            0.0,
        )
        for i in range(m)
    ]
    return x, frozen, n_qp


def _pnqp_is_exact(mode, m):
    """True when the inner control solve returns the EXACT optimum of its
    (masked/box) QP: free and mask modes always (direct masked solves);
    box mode when the m==1 closed form or the m<=3 active-set enumeration
    dispatches (the serial projected-Newton loop only approximates)."""
    enum_mode = _pnqp_enum_mode()
    return (
        mode != "box"
        or m == 1
        or (m == 2 and enum_mode != "0")
        or (m == 3 and enum_mode == "1")
    )


def _value_update(Q, q, Quu, qu, K, kt, n, m, exact):
    """Value-function update ``(V', v')`` from the gains, shared by all
    Riccati sweeps (the mega-kernel, the KKT kernel's auxiliary sweep).

    When ``exact`` — the gains are exact masked solves and ``kt`` is the
    exact inner-QP optimum (see :func:`_pnqp_is_exact`), with tiny ``reg``
    — the classic DDP cancellation applies: ``(Quu K)_free = -Qux_free``
    and ``(qu + Quu kt)_free = 0`` (frozen rows of ``K`` are zero, frozen
    dims of the QP gradient never enter), so

        ``V' = Qxx + sym(Qxu K)``      ``v' = qx + Qxu kt``

    dropping the ``K'Quu K`` / ``K'(qu + Quu kt)`` terms — fewer MACs and
    a shorter serial dependency chain per step. Error vs the full form is
    ``O(reg * |K|^2)`` plus f32 roundoff. Otherwise (box mode with the
    iterative pnqp, or large ``reg``) the full quadratic form is kept —
    the cancellation does not hold for an unconverged ``kt``.

    ``Q``/``q`` are the full (nm, nm)/(nm,) entry lists; returns ``Vn`` as
    an upper-mirrored n x n entry list and ``vn`` as an n entry list.
    """
    Vn = [[None] * n for _ in range(n)]
    if exact:
        for a in range(n):
            for b in range(a, n):
                qxuK_ab = sum(Q[a][n + r] * K[r][b] for r in range(m))
                qxuK_ba = sum(Q[b][n + r] * K[r][a] for r in range(m))
                val = Q[a][b] + 0.5 * (qxuK_ab + qxuK_ba)
                Vn[a][b] = val
                if b != a:
                    Vn[b][a] = val
        vn = [
            q[a] + sum(Q[a][n + r] * kt[r] for r in range(m))
            for a in range(n)
        ]
        return Vn, vn

    QuuK = [
        [sum(Quu[a][r] * K[r][j] for r in range(m)) for j in range(n)]
        for a in range(m)
    ]
    Quuk = [sum(Quu[a][r] * kt[r] for r in range(m)) for a in range(m)]
    for a in range(n):
        for b in range(a, n):
            qxuK_ab = sum(Q[a][n + r] * K[r][b] for r in range(m))
            qxuK_ba = sum(Q[b][n + r] * K[r][a] for r in range(m))
            kQk = sum(K[r][a] * QuuK[r][b] for r in range(m))
            val = Q[a][b] + qxuK_ab + qxuK_ba + kQk
            Vn[a][b] = val
            if b != a:
                Vn[b][a] = val
    vn = [
        q[a]
        + sum(Q[a][n + r] * kt[r] for r in range(m))
        + sum(K[r][a] * (qu[r] + Quuk[r]) for r in range(m))
        for a in range(n)
    ]
    return Vn, vn


# Threshold on reg below which the simplified value update MAY engage
# (the cancellation identity's O(reg * |K|^2) error could reach parity
# tolerances above it). Default -1.0 = ALWAYS use the full quadratic form,
# which keeps the XLA/kernel equivalence trivial. Set to e.g. 1e-6 before
# tracing to re-enable the simplified form (experiment knob; the identity
# and its tests remain — tests/test_value_update.py).
VALUE_UPDATE_EXACT_REG = -1.0


def _use_exact_value_update(mode, m, reg):
    """Trace-time gate for the simplified value update. Reads the module
    global so tests/A-Bs can monkeypatch ``riccati.VALUE_UPDATE_EXACT_REG``
    (e.g. to -1.0 to force the full form) before tracing."""
    return _pnqp_is_exact(mode, m) and reg <= VALUE_UPDATE_EXACT_REG


# ---------------------------------------------------------------------------
# Layout, parameter staging and the launch.
# ---------------------------------------------------------------------------


def out_struct(shape, ref_ins, dtype=jnp.float32):
    """``jax.ShapeDtypeStruct`` for a pallas_call output, typed with the
    union of the inputs' varying-manual-axes so the kernels compose with
    ``shard_map(..., check_vma=True)`` (outside a manual-axes context this
    is a plain struct)."""
    vma: set = set()
    for leaf in jax.tree_util.tree_leaves(ref_ins):
        vma |= set(jax.typeof(leaf).vma)
    if vma:
        return jax.ShapeDtypeStruct(shape, dtype, vma=frozenset(vma))
    return jax.ShapeDtypeStruct(shape, dtype)


def _to_kernel_layout(x, G, tile):
    """(T, B, d1, d2?) -> (G, T, d1, d2?, tile)."""
    x = jnp.moveaxis(x, 1, -1)  # (T, *trail, B)
    x = x.reshape(x.shape[:-1] + (G, tile))
    return jnp.moveaxis(x, -2, 0)  # (G, T, *trail, tile)


def _from_kernel_layout(x):
    """(G, T, d1, d2?, tile) -> (T, B, d1, d2?)."""
    x = jnp.moveaxis(x, 0, -2)  # (T, *trail, G, tile)
    x = x.reshape(x.shape[:-2] + (-1,))
    return jnp.moveaxis(x, -1, 1)


def stage_kernel_params(dyn, pad, G, tile):
    """Stage ``dyn.kernel_params()`` for a launch.

    Shared ``(P,)`` params stay one small array that every program reads
    as scalars; per-scenario ``(B, P)`` params become one ``(tile,)``
    vector per parameter per program (the scenario axis padded like every
    other input: pad rows repeat row 0, discarded on output but kept
    finite for in-kernel divisions).

    Returns ``(params_arr, n_params, shared)``.
    """
    params_raw = dyn.kernel_params().astype(jnp.float32)
    if params_raw.ndim == 2:
        if pad:
            params_raw = jnp.concatenate(
                [
                    params_raw,
                    jnp.broadcast_to(params_raw[:1], (pad, params_raw.shape[1])),
                ],
                axis=0,
            )
        params_arr = _to_kernel_layout(params_raw[None], G, tile)[:, 0]
        return params_arr, params_raw.shape[1], False
    params_arr = params_raw.reshape(-1)
    return params_arr, params_arr.shape[0], True


def read_kernel_params(params_ref, n_params):
    """In-kernel counterpart of :func:`stage_kernel_params`: one value per
    parameter, a scalar (shared) or a ``(tile,)`` vector (per scenario);
    both broadcast through ``entries_step`` arithmetic alike."""
    return [params_ref[j] for j in range(n_params)]


def launch(kernel, ins, out_shapes, *, tile, interpret, n_shared=0):
    """The one ``pallas_call`` of both kernels.

    The grid has one program per ``tile`` scenarios. Every input and
    output is ``(G, ..., tile)`` and each program sees its own slice with
    the leading axis squeezed away, except the first ``n_shared`` inputs,
    which every program sees whole (shared dynamics parameters). Outputs
    may include per-program working buffers (the Triton route has no
    scratch memory); the caller drops them.

    ``num_stages=1``: the kernels re-read, in later loop iterations,
    buffers they wrote in earlier ones, so no load may be software-
    pipelined ahead of those stores.
    """
    G = out_shapes[0].shape[0]

    def tiled(shape):
        return pl.BlockSpec(
            (None,) + tuple(shape[1:]),
            lambda g, nd=len(shape): (g,) + (0,) * (nd - 1),
        )

    def whole(shape):
        return pl.BlockSpec(tuple(shape), lambda g, nd=len(shape): (0,) * nd)

    return pl.pallas_call(
        kernel,
        grid=(G,),
        in_specs=[
            whole(x.shape) if i < n_shared else tiled(x.shape)
            for i, x in enumerate(ins)
        ],
        out_specs=[tiled(s.shape) for s in out_shapes],
        out_shape=out_shapes,
        interpret=interpret,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=tile // 32, num_stages=1
        ),
    )(*ins)
