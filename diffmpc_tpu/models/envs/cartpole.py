"""Differentiable cartpole dynamics.

Capability parity: the reference's ``mpc/env_dx/cartpole.py`` ``CartpoleDx``
(SURVEY.md §2.1 C7): state ``(p, pdot, cos th, sin th, thdot)``; force
control; learnable params ``(g, m_cart, m_pole, l)``; the standard
Barto-Sutton cartpole ODE Euler-integrated in the cos/sin angle encoding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ...utils import pytree as struct

from ...utils.batch import bclamp
from ..dynamics import Dynamics


@struct.dataclass
class CartpoleDx(Dynamics):
    params: jnp.ndarray  # (4,) = (g, m_cart, m_pole, l), learnable
    dt: float = struct.field(pytree_node=False, default=0.05)
    max_force: float = struct.field(pytree_node=False, default=100.0)
    clamp_ctrl: bool = struct.field(pytree_node=False, default=False)

    n_state: int = struct.field(pytree_node=False, default=5)
    n_ctrl: int = struct.field(pytree_node=False, default=1)

    @staticmethod
    def default(dtype=jnp.float32) -> "CartpoleDx":
        return CartpoleDx(params=jnp.array([9.8, 1.0, 0.1, 0.5], dtype))

    def forward(self, x, u):
        # trailing-axis indexing so per-scenario (B, 4) params broadcast
        # against (..., B) state entries (see Dynamics.param_batch_shape)
        g, m_cart, m_pole, l = (
            self.params[..., 0],
            self.params[..., 1],
            self.params[..., 2],
            self.params[..., 3],
        )
        total_mass = m_cart + m_pole
        polemass_l = m_pole * l

        p, pdot = x[..., 0], x[..., 1]
        cos_th, sin_th, thdot = x[..., 2], x[..., 3], x[..., 4]
        force = u[..., 0]
        if self.clamp_ctrl:
            force = bclamp(force, -self.max_force, self.max_force)
        th = jnp.arctan2(sin_th, cos_th)

        temp = (force + polemass_l * thdot**2 * sin_th) / total_mass
        th_acc = (g * sin_th - cos_th * temp) / (
            l * (4.0 / 3.0 - m_pole * cos_th**2 / total_mass)
        )
        p_acc = temp - polemass_l * th_acc * cos_th / total_mass

        p_new = p + self.dt * pdot
        pdot_new = pdot + self.dt * p_acc
        th_new = th + self.dt * thdot
        thdot_new = thdot + self.dt * th_acc
        return jnp.stack(
            [p_new, pdot_new, jnp.cos(th_new), jnp.sin(th_new), thdot_new], axis=-1
        )

    def kernel_params(self):
        return self.params

    def entries_step(self, params, x_entries, u_entries):
        """Entry-wise (batch-minor) dynamics step for Pallas kernel fusion;
        mathematically identical to :meth:`forward` (angle update via the
        rotation identity — ``arctan2`` is kept out of the kernels)."""
        g, m_cart, m_pole, l = params
        total_mass = m_cart + m_pole
        polemass_l = m_pole * l
        p, pdot, cos_th, sin_th, thdot = x_entries
        force = u_entries[0]
        if self.clamp_ctrl:
            force = bclamp(force, -self.max_force, self.max_force)
        temp = (force + polemass_l * thdot * thdot * sin_th) / total_mass
        th_acc = (g * sin_th - cos_th * temp) / (
            l * (4.0 / 3.0 - m_pole * cos_th * cos_th / total_mass)
        )
        p_acc = temp - polemass_l * th_acc * cos_th / total_mass
        inv_r = jax.lax.rsqrt(cos_th * cos_th + sin_th * sin_th)
        c_hat, s_hat = cos_th * inv_r, sin_th * inv_r
        d = self.dt * thdot
        cd, sd = jnp.cos(d), jnp.sin(d)
        return [
            p + self.dt * pdot,
            pdot + self.dt * p_acc,
            c_hat * cd - s_hat * sd,
            s_hat * cd + c_hat * sd,
            thdot + self.dt * th_acc,
        ]

    def get_true_obj(self, dtype=None):
        """Quadratic cost toward the upright, centered pole (ref C7)."""
        dtype = dtype or self.params.dtype
        goal_weights = jnp.array([0.1, 0.1, 1.0, 1.0, 0.1], dtype)
        goal_state = jnp.array([0.0, 0.0, 1.0, 0.0, 0.0], dtype)
        ctrl_penalty = 0.001
        q = jnp.concatenate([goal_weights, ctrl_penalty * jnp.ones(self.n_ctrl, dtype)])
        p = jnp.concatenate(
            [-goal_weights * goal_state, jnp.zeros(self.n_ctrl, dtype)]
        )
        return q, p

    def get_frame(self, x, ax=None):
        import matplotlib.pyplot as plt
        import numpy as np

        if self.param_batch_shape:
            raise ValueError(
                "get_frame renders one instance; select a scenario row "
                "first: dx.replace(params=dx.params[b]).get_frame(x[b])"
            )
        x = np.asarray(x)
        p = float(x[0])
        th = float(np.arctan2(x[3], x[2]))
        l = float(self.params[3])
        if ax is None:
            _, ax = plt.subplots(figsize=(6, 4))
        cart_w, cart_h = 0.4, 0.2
        ax.add_patch(
            plt.Rectangle((p - cart_w / 2, -cart_h / 2), cart_w, cart_h, color="k")
        )
        ax.plot([p, p + 2 * l * np.sin(th)], [0, 2 * l * np.cos(th)], color="b", lw=3)
        ax.set_xlim(p - 3, p + 3)
        ax.set_ylim(-1.5, 1.5)
        return ax
