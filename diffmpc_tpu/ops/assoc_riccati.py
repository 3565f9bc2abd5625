"""Parallel-in-time Riccati backward pass via ``lax.associative_scan``.

The reference's horizon loop is sequential Python, linear in ``T``
(SURVEY.md §5.7 — "long context" in this domain is a long horizon). The
Riccati recursion is an associative composition of conditional value
functions (Sarkka & Garcia-Fernandez, temporal parallelization of LQT;
PAPERS.md arXiv:1809.06360 / 2405.09197), so the backward pass can run in
O(log T) depth:

Each step ``t`` contributes the conditional value function

    V_t(x, z) = 0.5 (z - A x - b)' pinv(C)-form (z - A x - b)
              + 0.5 x' J x - eta' x

(max-plus Gaussian-like parametrization; singular ``C`` is handled
implicitly because the combination rule never inverts ``C`` alone), with the
associative combination (element i followed by element j, ``P = (I + C_i
J_j)^-1``, and ``(I + J_j C_i)^-1 = P'`` since ``C, J`` are symmetric):

    A_ij   = A_j P A_i
    b_ij   = A_j P (b_i + C_i eta_j) + b_j
    C_ij   = A_j P C_i A_j' + C_j
    eta_ij = A_i' P' (eta_j - J_j b_i) + eta_i
    J_ij   = A_i' P' J_j A_i + J_i

The per-step element absorbs our general stage cost (cross terms ``Q_xu``,
linear terms) by completing the square in ``u``:

    u-tilde = u + Quu^-1 (Qux x + qu)
    A_t   = F_x - F_u Quu^-1 Qux          b_t = f_t - F_u Quu^-1 qu
    C_t   = F_u Quu^-1 F_u'               J_t = Qxx - Qxu Quu^-1 Qux
    eta_t = -(qx - Qxu Quu^-1 qu)

and the last time step (no outgoing transition) sets ``A, b, C = 0``.
Suffix-combining elements ``t..T-1`` yields ``V_t(x) = 0.5 x' J x - eta' x``
(so ``v_t = -eta_t``); gains then come from one parallel batched solve per
step. Unconstrained only — active box sets couple time steps
non-associatively, so box problems use the sequential scan / Pallas kernel.

Status (round 2): two deployments.

- Single device, ``riccati_backward_assoc`` (``lax.associative_scan``):
  OFF by default; whether it beats the sequential scan at any shape on
  the GPU is not measured yet (ROADMAP).
- Time-sharded mesh, :func:`riccati_backward_time_sharded` (SURVEY.md
  §5.7 build (b)): the horizon is block-distributed over a ``('time',)``
  mesh — local sequential suffix-composition, an ``all_gather`` of the D
  chunk totals, a replicated length-D combine, one batched boundary
  combine, local gain recovery. Per-device sequential depth T/D + D.
  WINS over the single-stream sequential scan in the long-horizon,
  m ~ n regime (the combine works on n-sized value maps while the
  sequential step factors the (n+m)-sized Q): measured 1.76x at
  T=8192, B=8, n=m=4 on the 8-virtual-device (4-core) CPU mesh, 1.4x at
  T=4096-16384 B=16; loses at m=1 where the sequential step is nearly
  free (0.6x). Crossover pinned by
  tests/test_assoc_riccati.py::test_time_sharded_crossover_measurement.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..utils.batch import bmm, bmv, btrans, match_vma, symmetrize
from .lqr import RiccatiResult
from .smallchol import cholesky_small, cho_solve_small, solve_general_small


def _combine(e_i, e_j):
    """Associative combination; both elements batched (..., n, n)/(..., n)."""
    A1, b1, C1, eta1, J1 = e_i
    A2, b2, C2, eta2, J2 = e_j
    n = A1.shape[-1]
    eye = jnp.eye(n, dtype=A1.dtype)
    M = eye + bmm(C1, J2)  # (I + C_i J_j)
    # P X for the three right-hand sides we need
    rhs = jnp.concatenate([A1, (b1 + bmv(C1, eta2))[..., None], C1], axis=-1)
    sol = solve_general_small(M, rhs)
    PA1 = sol[..., :n]
    Pb = sol[..., n]
    PC1 = sol[..., n + 1 :]

    A = bmm(A2, PA1)
    b = bmv(A2, Pb) + b2
    C = symmetrize(bmm(A2, bmm(PC1, btrans(A2))) + C2)
    # (I + J2 C1)^-1 = P' ; apply via transposed solve
    rhs2 = jnp.concatenate([(eta2 - bmv(J2, b1))[..., None], bmm(J2, A1)], axis=-1)
    sol2 = solve_general_small(btrans(M), rhs2)
    eta = bmv(btrans(A1), sol2[..., 0]) + eta1
    J = symmetrize(bmm(btrans(A1), sol2[..., 1:]) + J1)
    return A, b, C, eta, J


def _build_elements(C, c, F, f, n, *, reg, zero_last=True):
    """Per-step conditional-value-function elements (module docstring): the
    embarrassingly-parallel part, shared by the single-chip associative scan
    and the time-sharded deployment. ``zero_last=False`` skips the
    terminal-step zeroing for callers that apply it conditionally (the
    time-sharded path, where only the globally-last chunk terminates)."""
    T, B = C.shape[0], C.shape[1]
    dtype = C.dtype
    Qxx = C[..., :n, :n]
    Qxu = C[..., :n, n:]
    Qux = C[..., n:, :n]
    Quu = C[..., n:, n:]
    qx = c[..., :n]
    qu = c[..., n:]
    Fx = F[..., :, :n]
    Fu = F[..., :, n:]

    chol_uu = cholesky_small(Quu, reg)
    iQuu_Qux = cho_solve_small(chol_uu, Qux)  # (T,B,m,n)
    iQuu_qu = cho_solve_small(chol_uu, qu[..., None])[..., 0]  # (T,B,m)
    iQuu_FuT = cho_solve_small(chol_uu, btrans(Fu))  # (T,B,m,n)

    A_el = Fx - bmm(Fu, iQuu_Qux)
    b_el = f - bmv(Fu, iQuu_qu)
    C_el = symmetrize(bmm(Fu, iQuu_FuT))
    J_el = symmetrize(Qxx - bmm(Qxu, iQuu_Qux))
    eta_el = -(qx - bmv(Qxu, iQuu_qu))

    if zero_last:
        # last step: stage cost only, no outgoing transition
        zero_nn = jnp.zeros((B, n, n), dtype)
        A_el = A_el.at[T - 1].set(zero_nn)
        b_el = b_el.at[T - 1].set(jnp.zeros((B, n), dtype))
        C_el = C_el.at[T - 1].set(zero_nn)
    return (A_el, b_el, C_el, eta_el, J_el)


def _identity_element(batch, n, dtype):
    """Neutral element of :func:`_combine` (A=I, everything else 0).
    ``batch``: int ``B`` or a tuple of leading batch dims (e.g. ``(D, B)``
    for the blocked formulation)."""
    bshape = (batch,) if isinstance(batch, int) else tuple(batch)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), bshape + (n, n))
    z_nn = jnp.zeros(bshape + (n, n), dtype)
    z_n = jnp.zeros(bshape + (n,), dtype)
    return (eye, z_n, z_nn, z_n, z_nn)


def _gains_from_value(C, c, F, f, V_next, v_next, n, reg):
    """Standard gain recovery — one parallel batched solve per step."""
    FtT = btrans(F)
    Q = symmetrize(C + bmm(FtT, bmm(V_next, F)))
    q = c + bmv(FtT, bmv(V_next, f) + v_next)
    chol = cholesky_small(Q[..., n:, n:], reg)
    rhs = jnp.concatenate([Q[..., n:, :n], q[..., n:, None]], axis=-1)
    Kk = -cho_solve_small(chol, rhs)
    return Kk[..., :n], Kk[..., n]


def riccati_backward_assoc(
    C: jnp.ndarray,
    c: jnp.ndarray,
    F: jnp.ndarray,
    f: Optional[jnp.ndarray],
    n_state: int,
    *,
    reg: float = 1e-9,
) -> RiccatiResult:
    """Drop-in replacement for the unconstrained
    :func:`diffmpc_tpu.ops.lqr.riccati_backward` with O(log T) time depth.

    Same contract: C (T,B,nm,nm), c (T,B,nm), F (T,B,n,nm), f (T,B,n)|None
    -> gains (K, k)."""
    n = n_state
    T, B, nm = C.shape[0], C.shape[1], C.shape[-1]
    m = nm - n
    dtype = C.dtype
    if f is None:
        f = jnp.zeros((T, B, n), dtype)

    elems = _build_elements(C, c, F, f, n, reg=reg)
    # suffix combinations: comb[t] = e_t * e_{t+1} * ... * e_{T-1}.
    # associative_scan(reverse=True) applies operands as
    # f(elems[t+1], elems[t]) (time-reversed orientation), so flip the
    # combiner's arguments to keep causal composition order.
    comb = jax.lax.associative_scan(
        lambda a, b: _combine(b, a), elems, axis=0, reverse=True
    )
    _, _, _, eta_c, J_c = comb

    # V_{t+1}, v_{t+1} sequences (zero at t = T-1)
    V_next = jnp.concatenate([J_c[1:], jnp.zeros((1, B, n, n), dtype)], axis=0)
    v_next = jnp.concatenate([-eta_c[1:], jnp.zeros((1, B, n), dtype)], axis=0)

    K, k = _gains_from_value(C, c, F, f, V_next, v_next, n, reg)
    free = jnp.ones((T, B, m), dtype=bool)
    return RiccatiResult(K, k, free, jnp.zeros((T, B), jnp.int32))


def riccati_backward_blocked(
    C: jnp.ndarray,
    c: jnp.ndarray,
    F: jnp.ndarray,
    f: Optional[jnp.ndarray],
    n_state: int,
    *,
    n_blocks: int,
    reg: float = 1e-9,
) -> RiccatiResult:
    """Single-chip blocked parallel-in-time Riccati (SURVEY.md §5.7) — the
    SAME blocked suffix-scan arithmetic :func:`riccati_backward_time_sharded`
    distributes over a ``('time',)`` mesh, run on one device with the block
    axis as a batch dimension. Sequential depth drops from ``T`` to
    ``T/D + D`` while every scan step works on a ``(D, B)``-wide batch, so
    it wins exactly where the chip is depth-bound (long horizon, small
    ``B``): a T=8192 recursion at B=8 runs 64 combines wide instead of one.

    This is also the single-device ground truth for the time-sharded path:
    on a mesh each device executes one block's column of this computation
    plus an ``all_gather`` of D tiny elements, so the single-device blocked
    time bounds the per-device critical path from above.

    Contract matches :func:`riccati_backward_assoc` (unconstrained only —
    active box sets couple steps non-associatively). ``T`` must be
    divisible by ``n_blocks``.
    """
    n = n_state
    T, B, nm = C.shape[0], C.shape[1], C.shape[-1]
    m = nm - n
    dtype = C.dtype
    if f is None:
        f = jnp.zeros((T, B, n), dtype)
    D = n_blocks
    if T % D != 0:
        raise ValueError(f"T={T} must be divisible by n_blocks={D}")
    L = T // D

    tree = jax.tree_util.tree_map
    elems = _build_elements(C, c, F, f, n, reg=reg)
    # (T, B, ...) -> (L, D, B, ...): block i owns t in [i*L, (i+1)*L)
    blk = tree(
        lambda e: e.reshape(D, L, *e.shape[1:]).swapaxes(0, 1), elems
    )

    def step(carry, e):
        comb = _combine(e, carry)
        return comb, comb

    # 1. local suffix composition, all D blocks as one batch:
    #    seq[l, i] = e_{iL+l} o ... o e_{(i+1)L-1}
    total, seq = jax.lax.scan(
        step, _identity_element((D, B), n, dtype), blk, reverse=True
    )

    # 2. suffix-compose the D block totals (the only depth-D part)
    _, rights = jax.lax.scan(
        step, _identity_element(B, n, dtype), total, reverse=True
    )
    ident = _identity_element(B, n, dtype)
    rights_excl = tree(
        lambda r, i: jnp.concatenate([r[1:], i[None]], axis=0), rights, ident
    )

    # 3. one fully batched boundary combine: glob[l, i] = seq[l, i] o
    #    (blocks i+1..D-1 total)
    right_b = tree(
        lambda r: jnp.broadcast_to(r[None], (L,) + r.shape), rights_excl
    )
    glob = _combine(seq, right_b)
    _, _, _, eta_g, J_g = glob
    _, _, _, eta_r, J_r = rights_excl

    # V_{t+1} per (l, i): within-block successor, or the right-neighbor
    # boundary value for the block-final step
    V_next = jnp.concatenate([J_g[1:], J_r[None]], axis=0)
    v_next = jnp.concatenate([-eta_g[1:], -eta_r[None]], axis=0)
    V_next = V_next.swapaxes(0, 1).reshape(T, B, n, n)
    v_next = v_next.swapaxes(0, 1).reshape(T, B, n)

    K, k = _gains_from_value(C, c, F, f, V_next, v_next, n, reg)
    free = jnp.ones((T, B, m), dtype=bool)
    return RiccatiResult(K, k, free, jnp.zeros((T, B), jnp.int32))


def riccati_backward_time_sharded(
    mesh,
    C: jnp.ndarray,
    c: jnp.ndarray,
    F: jnp.ndarray,
    f: Optional[jnp.ndarray],
    n_state: int,
    *,
    reg: float = 1e-9,
    time_axis: str = "time",
) -> RiccatiResult:
    """Horizon-sharded parallel-in-time Riccati (SURVEY.md §5.7 build (b)):
    the sequence-parallel deployment of the associative formulation.

    The horizon is block-distributed over the mesh's ``time_axis`` — the
    domain-correct analog of sequence parallelism (the recursion plays the
    role attention plays in transformers). Classic blocked scan, all inside
    one ``shard_map``:

    1. each device sequentially suffix-composes its own ``T/D`` chunk of
       value-function elements (work-efficient local ``lax.scan``),
    2. the ``D`` chunk-total elements are ``all_gather``ed (tiny — one
       ``(B, n, n)``-sized element per device)
       and suffix-composed in a length-``D`` scan replicated on every
       device,
    3. each local suffix is combined with the right-neighbor total in one
       fully batched :func:`_combine`, and gains are recovered locally.

    Per-device sequential depth drops from ``T`` to ``T/D + D``.
    Unconstrained only, like :func:`riccati_backward_assoc`. ``T`` must be
    divisible by the mesh size. Inputs may be passed unsharded; outputs come
    back time-sharded over the mesh.
    """
    from jax.sharding import PartitionSpec as P

    n = n_state
    T, B, nm = C.shape[0], C.shape[1], C.shape[-1]
    m = nm - n
    dtype = C.dtype
    if f is None:
        f = jnp.zeros((T, B, n), dtype)
    D = mesh.shape[time_axis]
    if T % D != 0:
        raise ValueError(f"T={T} must be divisible by the time-mesh size {D}")

    def local_block(C_l, c_l, F_l, f_l):
        elems = _build_elements_local(C_l, c_l, F_l, f_l)
        # scan carries must enter with the body outputs' VMA type under
        # check_vma=True (round-2 gotcha: literal-initialized carries) —
        # promote the identity element against the sharded elements
        ident = jax.tree_util.tree_map(
            lambda l: match_vma(l, elems), _identity_element(B, n, dtype)
        )

        # 1. local suffix composition: seq[t] = e_t o ... o e_{last local}
        def step(carry, e):
            comb = _combine(e, carry)
            return comb, comb

        total, seq = jax.lax.scan(step, ident, elems, reverse=True)

        # 2. chunk totals across devices; suffix-compose the D totals
        totals = jax.lax.all_gather(total, time_axis)  # (D, B, ...)
        # rights[i] = totals[i] o ... o totals[D-1]; right-exclusive shift
        _, rights = jax.lax.scan(step, ident, totals, reverse=True)
        rights_excl = jax.tree_util.tree_map(
            lambda r, i: jnp.concatenate([r[1:], i[None]], axis=0),
            rights,
            ident,
        )
        idx = jax.lax.axis_index(time_axis)
        my_right = jax.tree_util.tree_map(lambda r: r[idx], rights_excl)

        # 3. global suffix per local step in ONE batched combine
        T_l = C_l.shape[0]
        right_b = jax.tree_util.tree_map(
            lambda r: jnp.broadcast_to(r[None], (T_l,) + r.shape), my_right
        )
        glob = _combine(seq, right_b)
        _, _, _, eta_g, J_g = glob

        # V_{t+1} within the chunk: shift by one, boundary = my_right's value
        _, _, _, eta_r, J_r = my_right
        V_next = jnp.concatenate([J_g[1:], J_r[None]], axis=0)
        v_next = jnp.concatenate([-eta_g[1:], -eta_r[None]], axis=0)

        K, k = _gains_from_value(C_l, c_l, F_l, f_l, V_next, v_next, n, reg)
        return K, k

    def _build_elements_local(C_l, c_l, F_l, f_l):
        # the global T-1 zeroing of (A, b, C) in _build_elements must only
        # apply on the LAST chunk: build without it, zero conditionally on
        # the device index (one code path for the elimination formulas)
        A_el, b_el, C_el, eta_el, J_el = _build_elements(
            C_l, c_l, F_l, f_l, n, reg=reg, zero_last=False
        )
        is_last = jax.lax.axis_index(time_axis) == D - 1
        T_l = A_el.shape[0]
        sel = lambda x: jnp.where(is_last, jnp.zeros_like(x), x)
        A_el = A_el.at[T_l - 1].set(sel(A_el[T_l - 1]))
        b_el = b_el.at[T_l - 1].set(sel(b_el[T_l - 1]))
        C_el = C_el.at[T_l - 1].set(sel(C_el[T_l - 1]))
        return (A_el, b_el, C_el, eta_el, J_el)

    shard = jax.shard_map(
        local_block,
        mesh=mesh,
        in_specs=(P(time_axis), P(time_axis), P(time_axis), P(time_axis)),
        out_specs=(P(time_axis), P(time_axis)),
        check_vma=True,  # round 3: carries VMA-promoted via match_vma; the
        # axis_index-dependent element edits type fine under the checker
    )
    K, k = shard(C, c, F, f)
    free = jnp.ones((T, B, m), dtype=bool)
    return RiccatiResult(K, k, free, jnp.zeros((T, B), jnp.int32))
