"""Differentiable planar quadrotor (n=6, m=2) — hover stabilization.

Beyond the reference's env zoo (``mpc/env_dx/`` ships pendulum and cartpole
only — SURVEY.md §2.1 C6/C7): a multi-control nonlinear model exercising
the m>1 box-DDP machinery (in-kernel m=2 projected-Newton QP, asymmetric
thrust box ``0 <= u_i <= max_thrust``) on real dynamics rather than random
LQR problems.

State ``(px, pz, phi, vx, vz, om)``; controls ``(u1, u2)`` rotor thrusts;
learnable params ``(g, mass, arm, inertia)``; semi-implicit Euler step

    vx'  = vx + dt * (-(u1+u2) sin(phi) / mass)
    vz'  = vz + dt * ( (u1+u2) cos(phi) / mass - g)
    om'  = om + dt * arm * (u2 - u1) / inertia
    px'  = px + dt * vx';  pz' = pz + dt * vz';  phi' = phi + dt * om'

``get_true_obj`` builds the hover cost: quadratic weights toward the zero
state plus a control penalty centered at the hover thrust ``mass g / 2``
per rotor (a nonzero-setpoint linear term — the pendulum/cartpole costs
never exercise that).
"""

from __future__ import annotations

import jax.numpy as jnp
from ...utils import pytree as struct

from ...utils.batch import bclamp
from ..dynamics import Dynamics


@struct.dataclass
class QuadrotorDx(Dynamics):
    params: jnp.ndarray  # (4,) = (g, mass, arm, inertia), learnable
    max_thrust: float = struct.field(pytree_node=False, default=5.0)
    dt: float = struct.field(pytree_node=False, default=0.05)
    # Like the reference envs: clamp controls inside the dynamics so
    # standalone rollouts respect actuator limits; MPC box bounds make it
    # redundant during the solve.
    clamp_ctrl: bool = struct.field(pytree_node=False, default=True)

    n_state: int = struct.field(pytree_node=False, default=6)
    n_ctrl: int = struct.field(pytree_node=False, default=2)

    @staticmethod
    def default(dtype=jnp.float32) -> "QuadrotorDx":
        return QuadrotorDx(params=jnp.array([9.81, 0.5, 0.25, 0.01], dtype))

    def _split_params(self):
        # trailing-axis indexing so per-scenario (B, 4) params broadcast
        # against (..., B) state entries (see Dynamics.param_batch_shape)
        p = self.params
        return p[..., 0], p[..., 1], p[..., 2], p[..., 3]

    def hover_thrust(self):
        """Per-rotor thrust that exactly cancels gravity."""
        g, mass, _, _ = self._split_params()
        return g * mass / 2.0

    def forward(self, x, u):
        g, mass, arm, inertia = self._split_params()
        px, pz, phi, vx, vz, om = (x[..., i] for i in range(6))
        u1, u2 = u[..., 0], u[..., 1]
        if self.clamp_ctrl:
            u1 = bclamp(u1, 0.0, self.max_thrust)
            u2 = bclamp(u2, 0.0, self.max_thrust)
        thrust = u1 + u2
        s, c = jnp.sin(phi), jnp.cos(phi)
        nvx = vx + self.dt * (-thrust * s / mass)
        nvz = vz + self.dt * (thrust * c / mass - g)
        nom = om + self.dt * (arm * (u2 - u1) / inertia)
        return jnp.stack(
            [
                px + self.dt * nvx,
                pz + self.dt * nvz,
                phi + self.dt * nom,
                nvx,
                nvz,
                nom,
            ],
            axis=-1,
        )

    def kernel_params(self):
        return self.params

    def entries_step(self, params, x_entries, u_entries):
        """Entry-wise (batch-minor) step for Pallas kernel fusion — each
        entry a per-scenario vector; identical math to :meth:`forward` (sin/cos
        lower in the kernel; arctan2 is avoided)."""
        g, mass, arm, inertia = params
        px, pz, phi, vx, vz, om = x_entries
        u1, u2 = u_entries
        if self.clamp_ctrl:
            u1 = bclamp(u1, 0.0, self.max_thrust)
            u2 = bclamp(u2, 0.0, self.max_thrust)
        thrust = u1 + u2
        s, c = jnp.sin(phi), jnp.cos(phi)
        nvx = vx + self.dt * (-thrust * s / mass)
        nvz = vz + self.dt * (thrust * c / mass - g)
        nom = om + self.dt * (arm * (u2 - u1) / inertia)
        return [
            px + self.dt * nvx,
            pz + self.dt * nvz,
            phi + self.dt * nom,
            nvx,
            nvz,
            nom,
        ]

    # grad_input: inherited exact autodiff (jointly mapped over per-scenario
    # params). Under JAX AUTO_DIFF == ANALYTIC — no closed form is cheaper
    # here (docs/PARITY.md row GradMethods).

    def get_true_obj(self, dtype=None):
        """Hover cost ingredients ``(q, p)`` with ``C = diag(q)``,
        ``c = p``: position/attitude/velocity weights toward the zero state
        and a control penalty centered at the hover thrust (linear term
        ``-w_u u_hover`` — minimizing ``0.5 w_u u^2 - w_u u_hover u``
        recenters the penalty at ``u_hover``)."""
        if self.param_batch_shape:
            raise ValueError(
                "get_true_obj uses shared params; per-scenario costs go "
                "through the (T, B, ...) QuadCost contract directly"
            )
        dtype = dtype or self.params.dtype
        goal_weights = jnp.array([1.0, 1.0, 1.0, 0.1, 0.1, 0.1], dtype)
        ctrl_penalty = 0.01
        u_hover = self.hover_thrust().astype(dtype)
        q = jnp.concatenate(
            [goal_weights, ctrl_penalty * jnp.ones(self.n_ctrl, dtype)]
        )
        p = jnp.concatenate(
            [
                jnp.zeros(self.n_state, dtype),
                jnp.full((self.n_ctrl,), -ctrl_penalty * u_hover, dtype),
            ]
        )
        return q, p

    def get_frame(self, x, ax=None):
        """Render one matplotlib frame: body segment + rotor ticks."""
        import matplotlib.pyplot as plt
        import numpy as np

        if self.param_batch_shape:
            raise ValueError(
                "get_frame renders one instance; select a scenario row "
                "first: dx.replace(params=dx.params[b]).get_frame(x[b])"
            )
        x = np.asarray(x)
        px, pz, phi = float(x[0]), float(x[1]), float(x[2])
        arm = float(self.params[2])
        if ax is None:
            _, ax = plt.subplots(figsize=(4, 4))
        dx_, dz_ = arm * np.cos(phi), arm * np.sin(phi)
        ax.plot([px - dx_, px + dx_], [pz - dz_, pz + dz_], color="k", lw=3)
        for sgn in (-1, 1):
            rx, rz = px + sgn * dx_, pz + sgn * dz_
            ax.plot(
                [rx, rx - 0.3 * arm * np.sin(phi)],
                [rz, rz + 0.3 * arm * np.cos(phi)],
                color="b", lw=2,
            )
        lim = max(1.5, abs(px) + 1, abs(pz) + 1)
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        return ax
