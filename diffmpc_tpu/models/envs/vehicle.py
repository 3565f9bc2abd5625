"""Differentiable kinematic-bicycle vehicle (n=4, m=2) — lane keeping.

Beyond the reference's env zoo (``mpc/env_dx/`` ships pendulum and
cartpole — SURVEY.md §2.1 C6/C7): the canonical INDUSTRIAL MPC
application (vehicle path/lane control), with two controls on an
asymmetric box — acceleration bounded ``[-max_brake, max_accel]``
(braking authority exceeds drive authority, like a real car) and
steering ``|delta| <= max_steer``. Exercises the in-kernel m=2
active-set enumeration on a box whose two dims have different widths
and different symmetries.

State ``(px, py, psi, v)`` (position, heading, speed); controls
``(a, delta)``; learnable params ``(wheelbase L, drag c_d)``;
semi-implicit Euler step

    v'   = clamp(v + dt (a - c_d v), 0, v_max)
    psi' = psi + dt * v' tan(delta) / L
    px'  = px + dt * v' cos(psi')
    py'  = py + dt * v' sin(psi')

``tan`` is written ``sin/cos`` (|delta| <= 0.5 rad keeps cos > 0.87) so
:meth:`entries_step` uses only kernel-lowerable ops (no ``tan``/``atan2``).
The speed clamp uses the boundary-strict :func:`~diffmpc_tpu.utils.
batch.bclamp` (full Jacobian at v = 0 and v = v_max).

``get_true_obj`` builds the lane-keeping cost: lateral offset, heading
and speed error toward ``(py, psi, v) = (0, 0, v_ref)`` with progress
``px`` unpenalized, plus control penalties recentered at coast
(``a_ref = c_d v_ref``, the acceleration that holds ``v_ref`` — another
nonzero-setpoint linear term like the quadrotor's hover thrust).

Physics pins (tests/test_vehicle.py): the exact circular-motion
invariant — at constant speed and constant steer the discrete trajectory
lies on the circle of radius ``R = L / tan(delta)`` through the rear
axle (an analytic property independent of this implementation) — plus a
straight-line closed form and an f64 oracle transcription.
"""

from __future__ import annotations

import jax.numpy as jnp
from ...utils import pytree as struct

from ...utils.batch import bclamp
from ..dynamics import Dynamics


@struct.dataclass
class VehicleDx(Dynamics):
    params: jnp.ndarray  # (2,) = (wheelbase L, drag c_d), learnable
    max_accel: float = struct.field(pytree_node=False, default=3.0)
    max_brake: float = struct.field(pytree_node=False, default=6.0)
    max_steer: float = struct.field(pytree_node=False, default=0.5)
    max_speed: float = struct.field(pytree_node=False, default=15.0)
    v_ref: float = struct.field(pytree_node=False, default=5.0)
    dt: float = struct.field(pytree_node=False, default=0.05)
    clamp_ctrl: bool = struct.field(pytree_node=False, default=True)

    n_state: int = struct.field(pytree_node=False, default=4)
    n_ctrl: int = struct.field(pytree_node=False, default=2)

    @staticmethod
    def default(dtype=jnp.float32) -> "VehicleDx":
        return VehicleDx(params=jnp.array([2.7, 0.1], dtype))

    def _split_params(self):
        # trailing-axis indexing so per-scenario (B, 2) params broadcast
        # against (..., B) state entries (see Dynamics.param_batch_shape)
        p = self.params
        return p[..., 0], p[..., 1]

    def _step(self, L, c_d, px, py, psi, v, a, delta):
        """One semi-implicit Euler step in scalars/entries — the single
        copy of the sign-critical kinematics shared by :meth:`forward`
        and :meth:`entries_step` (the zoo idiom)."""
        if self.clamp_ctrl:
            a = bclamp(a, -self.max_brake, self.max_accel)
            delta = bclamp(delta, -self.max_steer, self.max_steer)
        nv = bclamp(v + self.dt * (a - c_d * v), 0.0, self.max_speed)
        # tan via sin/cos: kernel-lowerable, pole-free for |delta| <= 0.5
        tan_d = jnp.sin(delta) / jnp.cos(delta)
        npsi = psi + self.dt * nv * tan_d / L
        npx = px + self.dt * nv * jnp.cos(npsi)
        npy = py + self.dt * nv * jnp.sin(npsi)
        return npx, npy, npsi, nv

    def forward(self, x, u):
        L, c_d = self._split_params()
        px, py, psi, v = (x[..., i] for i in range(4))
        a, delta = u[..., 0], u[..., 1]
        return jnp.stack(
            self._step(L, c_d, px, py, psi, v, a, delta), axis=-1
        )

    def kernel_params(self):
        return self.params

    def entries_step(self, params, x_entries, u_entries):
        """Entry-wise (batch-minor) step for Pallas kernel fusion — each
        entry a per-scenario vector; identical math via :meth:`_step`."""
        L, c_d = params
        px, py, psi, v = x_entries
        a, delta = u_entries
        return list(self._step(L, c_d, px, py, psi, v, a, delta))

    # grad_input: inherited exact autodiff (AUTO_DIFF == ANALYTIC under JAX).

    def coast_accel(self):
        """Acceleration that exactly holds ``v_ref`` against drag."""
        _, c_d = self._split_params()
        return c_d * self.v_ref

    def get_true_obj(self, dtype=None):
        """Lane-keeping cost ingredients ``(q, p)``: lateral offset,
        heading and speed error toward ``(0, 0, v_ref)`` (progress ``px``
        free), control penalties recentered at ``(coast_accel, 0)``."""
        if self.param_batch_shape:
            raise ValueError(
                "get_true_obj uses shared params; per-scenario costs go "
                "through the (T, B, ...) QuadCost contract directly"
            )
        dtype = dtype or self.params.dtype
        goal_weights = jnp.array([0.0, 1.0, 2.0, 0.5], dtype)
        goal_state = jnp.array([0.0, 0.0, 0.0, self.v_ref], dtype)
        ctrl_penalty = jnp.array([0.1, 0.5], dtype)
        a_ref = self.coast_accel().astype(dtype)
        q = jnp.concatenate([goal_weights, ctrl_penalty])
        p = jnp.concatenate(
            [
                -goal_weights * goal_state,
                jnp.stack([-ctrl_penalty[0] * a_ref,
                           jnp.zeros((), dtype)]),
            ]
        )
        return q, p

    def get_frame(self, x, ax=None):
        """Render one matplotlib frame: the car as an oriented wheelbase
        segment on the lane (y = 0 dashed)."""
        import matplotlib.pyplot as plt
        import numpy as np

        if self.param_batch_shape:
            raise ValueError(
                "get_frame renders one instance; select a scenario row "
                "first: dx.replace(params=dx.params[b]).get_frame(x[b])"
            )
        x = np.asarray(x)
        px, py, psi = float(x[0]), float(x[1]), float(x[2])
        L = float(self.params[0])
        if ax is None:
            _, ax = plt.subplots(figsize=(6, 3))
        ax.axhline(0.0, color="0.7", ls="--", lw=1)
        fx, fy = px + L * np.cos(psi), py + L * np.sin(psi)
        ax.plot([px, fx], [py, fy], color="k", lw=3)
        ax.plot([px], [py], marker="s", color="b")
        ax.set_xlim(px - 2 * L, px + 2 * L)
        ax.set_ylim(-2.5, 2.5)
        return ax
