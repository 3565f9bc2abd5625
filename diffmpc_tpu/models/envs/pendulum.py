"""Differentiable swing-up pendulum dynamics.

Capability parity: the reference's ``mpc/env_dx/pendulum.py`` ``PendulumDx``
(SURVEY.md §2.1 C6): state ``(cos th, sin th, thdot)``; torque control
clamped to ``+-max_torque``; learnable physical params ``(g, m, l)``
(a sysid/imitation target); semi-implicit Euler step

    thdot' = thdot + dt * (-3 g / (2 l) sin(th + pi) + 3 u / (m l^2))
    th'    = th + dt * thdot'

with ``dt = 0.05`` and ``thdot`` clamped to ``+-max_speed = 8``.
``get_true_obj`` returns the goal-state quadratic cost ingredients
(weights ``(1, 1, 0.1)`` toward upright ``(1, 0, 0)``, control penalty
``1e-3``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ...utils import pytree as struct

from ...utils.batch import bclamp
from ..dynamics import Dynamics


@struct.dataclass
class PendulumDx(Dynamics):
    params: jnp.ndarray  # (3,) = (g, m, l), learnable
    max_torque: float = struct.field(pytree_node=False, default=2.0)
    max_speed: float = struct.field(pytree_node=False, default=8.0)
    dt: float = struct.field(pytree_node=False, default=0.05)
    # Reference knob: if True the torque is squashed/clamped inside the
    # dynamics; MPC box bounds make this redundant, but standalone rollouts
    # (expert-data generation) rely on it.
    clamp_ctrl: bool = struct.field(pytree_node=False, default=True)

    n_state: int = struct.field(pytree_node=False, default=3)
    n_ctrl: int = struct.field(pytree_node=False, default=1)

    @staticmethod
    def default(dtype=jnp.float32) -> "PendulumDx":
        return PendulumDx(params=jnp.array([10.0, 1.0, 1.0], dtype))

    def forward(self, x, u):
        # trailing-axis indexing so per-scenario (B, 3) params broadcast
        # against (..., B) state entries (see Dynamics.param_batch_shape)
        g, m, l = self.params[..., 0], self.params[..., 1], self.params[..., 2]
        cos_th, sin_th, thdot = x[..., 0], x[..., 1], x[..., 2]
        uu = u[..., 0]
        if self.clamp_ctrl:
            uu = bclamp(uu, -self.max_torque, self.max_torque)
        th = jnp.arctan2(sin_th, cos_th)
        # sin(th + pi) = -sin(th)
        newthdot = thdot + self.dt * (
            3.0 * g / (2.0 * l) * sin_th + 3.0 * uu / (m * l * l)
        )
        newthdot = bclamp(newthdot, -self.max_speed, self.max_speed)
        newth = th + self.dt * newthdot
        return jnp.stack([jnp.cos(newth), jnp.sin(newth), newthdot], axis=-1)

    def kernel_params(self):
        """Parameter vector consumed by :meth:`entries_step` inside Pallas
        kernels (see ops/pallas/rollout.py)."""
        return self.params

    def entries_step(self, params, x_entries, u_entries):
        """Entry-wise (batch-minor) dynamics step for kernel fusion: each
        entry is a vector over scenarios; ``params`` is a list of
        scalars. Mathematically identical to :meth:`forward`, but the angle
        update uses the rotation identity
        ``(cos, sin)(th + d) = (cos th cos d - sin th sin d, ...)`` instead
        of ``arctan2`` (kept out of the kernels — CLAUDE.md)."""
        g, m, l = params[0], params[1], params[2]
        cos_th, sin_th, thdot = x_entries
        uu = u_entries[0]
        if self.clamp_ctrl:
            uu = bclamp(uu, -self.max_torque, self.max_torque)
        newthdot = thdot + self.dt * (
            3.0 * g / (2.0 * l) * sin_th + 3.0 * uu / (m * l * l)
        )
        newthdot = bclamp(newthdot, -self.max_speed, self.max_speed)
        inv_r = jax.lax.rsqrt(cos_th * cos_th + sin_th * sin_th)
        c_hat, s_hat = cos_th * inv_r, sin_th * inv_r
        d = self.dt * newthdot
        cd, sd = jnp.cos(d), jnp.sin(d)
        return [c_hat * cd - s_hat * sd, s_hat * cd + c_hat * sd, newthdot]

    def grad_input(self, x, u):
        """Closed-form Jacobians of the Euler step (ref C6 analytic path).

        With r2 = cos^2 + sin^2 (= 1 on the constraint manifold),
        d th / d cos = -sin / r2, d th / d sin = cos / r2.
        Saturations (torque clamp, speed clamp) zero the relevant rows,
        matching autodiff through the boundary-strict ``bclamp``.
        """
        g, m, l = self.params[..., 0], self.params[..., 1], self.params[..., 2]
        cos_th, sin_th, thdot = x[..., 0], x[..., 1], x[..., 2]
        uu = u[..., 0]
        dt = self.dt

        # STRICT inequalities: MPC controls sit exactly on the box bound,
        # so the boundary convention is load-bearing for box-DDP — the
        # derivative must be 1 there (a zero or halved control Jacobian
        # would blind the solver). forward/entries_step use utils.batch
        # .bclamp for the same reason: jnp.clip's tie gradient is 0.5.
        u_sat = (
            (uu < -self.max_torque) | (uu > self.max_torque)
            if self.clamp_ctrl
            else jnp.zeros_like(uu, bool)
        )
        du = jnp.where(u_sat, 0.0, 1.0)

        r2 = cos_th * cos_th + sin_th * sin_th
        dth_dcos = -sin_th / r2
        dth_dsin = cos_th / r2

        # newthdot = thdot + dt*(1.5 g/l sin + 3 u/(m l^2)), then speed clamp
        a_sin = dt * 1.5 * g / l
        b_u = dt * 3.0 / (m * l * l)
        ntd_pre = thdot + a_sin * sin_th + b_u * jnp.clip(
            uu, -self.max_torque, self.max_torque
        ) if self.clamp_ctrl else thdot + a_sin * sin_th + b_u * uu
        sat = (ntd_pre < -self.max_speed) | (ntd_pre > self.max_speed)
        dsat = jnp.where(sat, 0.0, 1.0)

        d_ntd_dcos = jnp.zeros_like(cos_th)
        d_ntd_dsin = dsat * a_sin
        d_ntd_dthdot = dsat * 1.0
        d_ntd_du = dsat * b_u * du

        # newth = th + dt * newthdot
        d_nth_dcos = dth_dcos + dt * d_ntd_dcos
        d_nth_dsin = dth_dsin + dt * d_ntd_dsin
        d_nth_dthdot = dt * d_ntd_dthdot
        d_nth_du = dt * d_ntd_du

        ntd = jnp.clip(ntd_pre, -self.max_speed, self.max_speed)
        th = jnp.arctan2(sin_th, cos_th)
        nth = th + dt * ntd
        c_n, s_n = jnp.cos(nth), jnp.sin(nth)

        # rows: (cos nth, sin nth, ntd); chain through nth
        A = jnp.stack(
            [
                jnp.stack([-s_n * d_nth_dcos, -s_n * d_nth_dsin, -s_n * d_nth_dthdot], -1),
                jnp.stack([c_n * d_nth_dcos, c_n * d_nth_dsin, c_n * d_nth_dthdot], -1),
                jnp.stack([d_ntd_dcos, d_ntd_dsin, d_ntd_dthdot], -1),
            ],
            axis=-2,
        )
        B = jnp.stack([-s_n * d_nth_du, c_n * d_nth_du, d_ntd_du], -1)[..., None]
        return A, B

    def get_true_obj(self, dtype=None):
        """Goal-state quadratic cost ingredients (ref C6 ``get_true_obj``):
        returns ``(q, p)`` with ``C = diag(q)``, ``c = p`` so the cost
        ``0.5 tau' C tau + c' tau`` is minimized at the upright goal."""
        dtype = dtype or self.params.dtype
        goal_weights = jnp.array([1.0, 1.0, 0.1], dtype)
        goal_state = jnp.array([1.0, 0.0, 0.0], dtype)
        ctrl_penalty = 0.001
        q = jnp.concatenate([goal_weights, ctrl_penalty * jnp.ones(self.n_ctrl, dtype)])
        p = jnp.concatenate(
            [-goal_weights * goal_state, jnp.zeros(self.n_ctrl, dtype)]
        )
        return q, p

    def angle_from_state(self, x):
        return jnp.arctan2(x[..., 1], x[..., 0])

    def get_frame(self, x, ax=None):
        """Render one matplotlib frame (ref C6 ``get_frame``). Host-side
        utility; requires matplotlib."""
        import matplotlib.pyplot as plt
        import numpy as np

        if self.param_batch_shape:
            raise ValueError(
                "get_frame renders one instance; select a scenario row "
                "first: dx.replace(params=dx.params[b]).get_frame(x[b])"
            )
        x = np.asarray(x)
        th = float(np.arctan2(x[1], x[0]))
        l = float(self.params[2])
        if ax is None:
            _, ax = plt.subplots(figsize=(4, 4))
        ax.plot([0.0, l * np.sin(th)], [0.0, l * np.cos(th)], color="k", lw=3)
        ax.set_xlim(-1.2 * l, 1.2 * l)
        ax.set_ylim(-1.2 * l, 1.2 * l)
        return ax
