"""Dynamics model zoo.

Capability parity: the reference's ``mpc/dynamics.py`` (SURVEY.md §2.1 C5) —
``AffineDynamics``, ``NNDynamics`` (MLP state-transition model) and
``CtrlPassthroughDynamics``. Every model is a frozen dataclass pytree
(:mod:`diffmpc_tpu.utils.pytree`) whose parameters flow through ``jit``/``grad``/
``vmap``/``shard_map``; ``forward`` broadcasts over arbitrary leading batch
dims and ``grad_input`` returns the state/control Jacobians ``(A, B)`` used
for ``GradMethods.ANALYTIC`` linearization in the iLQR loop.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import jax
import jax.numpy as jnp
from ..utils import pytree as struct

from ..utils.batch import PRECISION


class Dynamics:
    """Protocol: ``forward(x, u) -> x_next`` (batched over leading dims) and
    ``grad_input(x, u) -> (A, B)`` with ``A: (..., n, n)``, ``B: (..., n, m)``.

    Per-scenario (domain-randomized) parameters: models whose ``params`` is
    a single array support an extra leading batch axis — ``(B, P)`` instead
    of ``(P,)`` — giving every scenario in the solve batch its own physics.
    The env ``forward``/``grad_input`` implementations broadcast the
    trailing-``P`` layout, and gradients w.r.t. the batched params flow
    per-scenario through the analytic KKT backward unchanged (the cotangent
    of a ``(B,)`` parameter row never crosses scenarios).
    """

    def forward(self, x, u):  # pragma: no cover - interface
        raise NotImplementedError

    @property
    def param_batch_shape(self) -> tuple:
        """Leading batch shape of per-scenario ``params`` (``()`` for the
        usual shared-parameter case, or when params is a pytree)."""
        p = getattr(self, "params", None)
        if hasattr(p, "ndim") and hasattr(p, "shape") and p.ndim >= 2:
            return tuple(p.shape[:-1])
        return ()

    @property
    def kernel_fusable(self) -> bool:
        """Whether ``entries_step`` (if present) may run inside the fused
        Pallas kernels. Per-scenario params ride them as one vector per
        parameter per program tile; pytree-params models override with their own criteria."""
        return True

    def grad_input(self, x, u):
        """Default: exact Jacobians via vmapped jacfwd (AUTO_DIFF == ANALYTIC
        under JAX; models override with closed forms when cheaper)."""
        bshape = self.param_batch_shape
        if not bshape:
            return autodiff_grad_input(self.forward, x, u)
        # Per-scenario params: map jacfwd jointly over (params, x, u) on the
        # scenario axis (a closure over (B, P) params inside a per-sample
        # vmap would silently broadcast wrong shapes).
        if x.ndim not in (2, 3):
            raise ValueError(
                f"per-scenario params need x of shape (B, n) or (T, B, n); "
                f"got {x.shape}"
            )

        def one(p, xx, uu):
            dxp = self.replace(params=p)
            return jax.jacfwd(
                lambda a, b: dxp.forward(a, b), argnums=(0, 1)
            )(xx, uu)

        f = jax.vmap(one)  # over the scenario axis
        if x.ndim == 3:
            f = jax.vmap(f, in_axes=(None, 0, 0))  # over time
        return f(self.params, x, u)

    def __call__(self, x, u):
        return self.forward(x, u)


def autodiff_grad_input(fwd: Callable, x: jnp.ndarray, u: jnp.ndarray):
    """Batched exact Jacobians of ``fwd`` w.r.t. ``x`` and ``u``.

    Works for any leading batch shape by flattening, vmapping ``jacfwd`` over
    single samples, and unflattening. This is the JAX replacement for the
    reference's autograd-jacobian path (``mpc/dynamics.py: NNDynamics.
    grad_input`` and ``mpc/mpc.py: linearize_dynamics`` AUTO_DIFF).
    """
    batch_shape = x.shape[:-1]
    n = x.shape[-1]
    m = u.shape[-1]
    xf = x.reshape(-1, n)
    uf = u.reshape(-1, m)
    jac = jax.vmap(jax.jacfwd(lambda xx, uu: fwd(xx, uu), argnums=(0, 1)))
    A, B = jac(xf, uf)
    return A.reshape(*batch_shape, n, n), B.reshape(*batch_shape, n, m)


@struct.dataclass
class AffineDynamics(Dynamics):
    """``x_next = A x + B u + c`` with exact ``grad_input`` (ref C5)."""

    A: jnp.ndarray  # (n, n) or (..., n, n)
    B: jnp.ndarray  # (n, m) or (..., n, m)
    c: jnp.ndarray | None = None  # (n,) or (..., n)

    def forward(self, x, u):
        out = jnp.einsum(
            "...ij,...j->...i", self.A, x, precision=PRECISION
        ) + jnp.einsum("...ij,...j->...i", self.B, u, precision=PRECISION)
        if self.c is not None:
            out = out + self.c
        return out

    def grad_input(self, x, u):
        batch_shape = x.shape[:-1]
        n = x.shape[-1]
        m = u.shape[-1]
        A = jnp.broadcast_to(self.A, (*batch_shape, n, n))
        B = jnp.broadcast_to(self.B, (*batch_shape, n, m))
        return A, B


def _act(name: str):
    return {
        "relu": jax.nn.relu,
        "tanh": jnp.tanh,
        "sigmoid": jax.nn.sigmoid,
        "elu": jax.nn.elu,
        "softplus": jax.nn.softplus,
        "gelu": jax.nn.gelu,
    }[name]


@struct.dataclass
class NNDynamics(Dynamics):
    """MLP state-transition model on ``[x; u]`` (ref C5 ``NNDynamics``).

    ``weights[i]: (d_in, d_out)``, ``biases[i]: (d_out,)``; the final layer
    outputs ``n_state``. ``residual=True`` predicts a delta added to ``x``
    (a common stabilization; off by default for reference parity).
    """

    weights: Tuple[jnp.ndarray, ...]
    biases: Tuple[jnp.ndarray, ...]
    activation: str = struct.field(pytree_node=False, default="tanh")
    residual: bool = struct.field(pytree_node=False, default=False)

    @staticmethod
    def init(
        key,
        n_state: int,
        n_ctrl: int,
        hidden: Sequence[int] = (64, 64),
        activation: str = "tanh",
        residual: bool = False,
        dtype=jnp.float32,
    ) -> "NNDynamics":
        sizes = [n_state + n_ctrl, *hidden, n_state]
        ws, bs = [], []
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            key, sub = jax.random.split(key)
            scale = jnp.sqrt(2.0 / a).astype(dtype)
            ws.append(jax.random.normal(sub, (a, b), dtype) * scale)
            bs.append(jnp.zeros((b,), dtype))
        return NNDynamics(tuple(ws), tuple(bs), activation, residual)

    def forward(self, x, u):
        h = jnp.concatenate([x, u], axis=-1)
        act = _act(self.activation)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            h = jnp.einsum("...i,ij->...j", h, w, precision=PRECISION) + b
            if i < len(self.weights) - 1:
                h = act(h)
        return x + h if self.residual else h

    # ------------------------------------------------------------------
    # Kernel fusion protocol (ops/pallas/ilqr.py): lets learned-dynamics
    # problems (NN imitation, SURVEY.md §3.5) ride the fused mega-kernel.
    # Weights are scalars every program reads and each hidden unit is one
    # per-scenario vector, so this is only profitable (and compilable in
    # reasonable time — the layer loops unroll) for small policies/models;
    # `kernel_fusable` gates the dispatch accordingly.
    # ------------------------------------------------------------------

    _FUSABLE_MAX_PARAMS = 1024
    _FUSABLE_MAX_WIDTH = 32

    @property
    def kernel_fusable(self) -> bool:
        n_params = sum(w.size for w in self.weights) + sum(
            b.size for b in self.biases
        )
        widths = [w.shape[1] for w in self.weights[:-1]]
        return n_params <= self._FUSABLE_MAX_PARAMS and all(
            h <= self._FUSABLE_MAX_WIDTH for h in widths
        )

    def kernel_params(self):
        """Flat parameter vector for the kernels: per layer, row-major W then b —
        must match :meth:`entries_step`'s unpacking order."""
        parts = []
        for w, b in zip(self.weights, self.biases):
            parts.append(w.reshape(-1))
            parts.append(b)
        return jnp.concatenate(parts)

    def entries_step(self, params, x_entries, u_entries):
        """Entry-wise (batch-minor) MLP step: each entry is a vector over
        scenarios; ``params`` is the flat scalar list from
        :meth:`kernel_params`. Mathematically identical to :meth:`forward`
        (all ops elementwise on per-scenario vectors)."""
        h = list(x_entries) + list(u_entries)
        n_x = len(x_entries)
        act = _act(self.activation)
        idx = 0
        n_layers = len(self.weights)
        for li, (w, b) in enumerate(zip(self.weights, self.biases)):
            din, dout = w.shape
            W = [
                [params[idx + i * dout + j] for j in range(dout)]
                for i in range(din)
            ]
            idx += din * dout
            bias = [params[idx + j] for j in range(dout)]
            idx += dout
            h = [
                sum(W[i][j] * h[i] for i in range(din)) + bias[j]
                for j in range(dout)
            ]
            if li < n_layers - 1:
                h = [act(z) for z in h]
        if self.residual:
            h = [x_entries[i] + h[i] for i in range(n_x)]
        return h


@struct.dataclass
class CtrlPassthroughDynamics(Dynamics):
    """Wraps ``inner`` so the state carries a copy of the control:
    state ``[u_tilde; x]``, next state ``[u; inner(x, u)]`` (ref C5).

    Used by the slew-rate-penalty formulation, where the previous control
    must be visible to the cost (SURVEY.md §2.1 C4 ``slew_rate_penalty``).
    """

    inner: Dynamics
    n_ctrl: int = struct.field(pytree_node=False)

    def forward(self, x, u):
        m = self.n_ctrl
        inner_x = x[..., m:]
        x_next = self.inner.forward(inner_x, u)
        return jnp.concatenate([u, x_next], axis=-1)

    def grad_input(self, x, u):
        """Compose the inner model's Jacobians:
        A' = [[0, 0], [0, A]], B' = [[I], [B]] in the [u_tilde; x] layout."""
        m = self.n_ctrl
        inner_x = x[..., m:]
        A_i, B_i = self.inner.grad_input(inner_x, u)
        batch = x.shape[:-1]
        n_i = inner_x.shape[-1]
        dtype = x.dtype
        zeros_tm = jnp.zeros((*batch, m, m + n_i), dtype)
        A_top = zeros_tm  # d u_tilde' / d [u_tilde; x] = 0
        A_bot = jnp.concatenate(
            [jnp.zeros((*batch, n_i, m), dtype), A_i], axis=-1
        )
        A = jnp.concatenate([A_top, A_bot], axis=-2)
        B_top = jnp.broadcast_to(jnp.eye(m, dtype=dtype), (*batch, m, m))
        B = jnp.concatenate([B_top, B_i], axis=-2)
        return A, B

    # ------------------------------------------------------------------
    # Kernel fusion protocol by composition: when the wrapped model is
    # entries-fusable, the augmented [u_tilde; x] system is too — the first
    # m state entries of the next step are just the control entries. This
    # lets the slew-rate-penalty formulation (mpc._augment_slew) ride the
    # fused mega-kernel instead of falling back to the XLA orchestration.
    # ------------------------------------------------------------------

    @property
    def kernel_fusable(self) -> bool:
        return (
            hasattr(self.inner, "entries_step")
            and hasattr(self.inner, "kernel_params")
            and getattr(self.inner, "kernel_fusable", True)
        )

    def kernel_params(self):
        return self.inner.kernel_params()

    def entries_step(self, params, x_entries, u_entries):
        nxt = self.inner.entries_step(
            params, x_entries[self.n_ctrl :], u_entries
        )
        return list(u_entries) + list(nxt)
