"""Differentiable acrobot (underactuated double pendulum, n=6, m=1).

Beyond the reference's env zoo (``mpc/env_dx/`` ships pendulum and
cartpole — SURVEY.md §2.1 C6/C7): the classic underactuated benchmark,
and the first env whose mass matrix is CONFIGURATION-DEPENDENT — the step
solves a 2x2 linear system ``M(q) qdd = rhs`` in closed form, which
exercises the ``entries_step`` kernel-fusion protocol on real
rigid-body-style dynamics (division by a state-dependent determinant)
rather than the constant-mass integrators of the other envs.

State ``(cos th1, sin th1, cos th2, sin th2, om1, om2)`` with ``th1``
measured from UPRIGHT (goal = ``(1, 0, 1, 0, 0, 0)``) and ``th2`` the
relative elbow angle; one control: elbow torque, clamped to
``+-max_torque``. Learnable params ``(m1, m2, l1, l2)`` (uniform rods:
``lc_i = l_i/2``, ``I_i = m_i l_i^2 / 12``; ``g = 9.8`` fixed). Standard
acrobot equations of motion (Spong; Sutton & Barto's task with the angle
origin moved to upright), semi-implicit Euler at ``dt = 0.01``, speed
clamps ``|om1| <= 4 pi``, ``|om2| <= 9 pi``.

``dt`` note: the upright equilibrium's unstable pole is ~7 rad/s at the
default masses, so 20 Hz discrete control (the pendulum/cartpole
``dt = 0.05``) is too slow to balance — the one-step growth factor is
1.43 and the correcting torques it demands leave the linear neighborhood
for perturbations beyond ~0.01 rad (measured: the f64 discrete-LQR basin
collapses; energy-conservation checks pin the physics itself). 100 Hz
(growth 1.07/step) balances comfortably; hence the finer default.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ...utils import pytree as struct

from ...utils.batch import bclamp
from ..dynamics import Dynamics

_G = 9.8


@struct.dataclass
class AcrobotDx(Dynamics):
    params: jnp.ndarray  # (4,) = (m1, m2, l1, l2), learnable
    max_torque: float = struct.field(pytree_node=False, default=4.0)
    max_speed1: float = struct.field(pytree_node=False, default=4.0 * jnp.pi)
    max_speed2: float = struct.field(pytree_node=False, default=9.0 * jnp.pi)
    dt: float = struct.field(pytree_node=False, default=0.01)
    clamp_ctrl: bool = struct.field(pytree_node=False, default=True)

    n_state: int = struct.field(pytree_node=False, default=6)
    n_ctrl: int = struct.field(pytree_node=False, default=1)

    @staticmethod
    def default(dtype=jnp.float32) -> "AcrobotDx":
        return AcrobotDx(params=jnp.array([1.0, 1.0, 1.0, 1.0], dtype))

    def _split_params(self):
        # trailing-axis indexing so per-scenario (B, 4) params broadcast
        # against (..., B) state entries (see Dynamics.param_batch_shape)
        p = self.params
        return p[..., 0], p[..., 1], p[..., 2], p[..., 3]

    def _accelerations(self, p, c1, s1, c2, s2, om1, om2, tau):
        """Closed-form ``qdd = M(q)^{-1} (B tau - C(q, qd) qd - G(q))``.

        ``p`` is the 4-tuple ``(m1, m2, l1, l2)`` — passed explicitly so
        :meth:`forward` (trailing-axis param slices) and
        :meth:`entries_step` (per-scenario vectors) share ONE copy of the
        sign-critical rigid-body math (the idiom the fused Riccati kernels
        use for their formula helpers)."""
        m1, m2, l1, l2 = p
        lc1, lc2 = 0.5 * l1, 0.5 * l2
        i1 = m1 * l1 * l1 / 12.0
        i2 = m2 * l2 * l2 / 12.0

        m11 = (
            m1 * lc1 * lc1 + i1
            + m2 * (l1 * l1 + lc2 * lc2 + 2.0 * l1 * lc2 * c2) + i2
        )
        m12 = m2 * (lc2 * lc2 + l1 * lc2 * c2) + i2
        m22 = m2 * lc2 * lc2 + i2

        h = m2 * l1 * lc2 * s2
        cor1 = -h * om2 * om2 - 2.0 * h * om1 * om2
        cor2 = h * om1 * om1

        # th from UPRIGHT: U = (m1 lc1 + m2 l1) g cos th1 + m2 lc2 g cos(th1+th2)
        s12 = s1 * c2 + c1 * s2
        g1 = -(m1 * lc1 + m2 * l1) * _G * s1 - m2 * lc2 * _G * s12
        g2 = -m2 * lc2 * _G * s12

        b1 = -cor1 - g1
        b2 = tau - cor2 - g2
        det = m11 * m22 - m12 * m12
        qdd1 = (m22 * b1 - m12 * b2) / det
        qdd2 = (m11 * b2 - m12 * b1) / det
        return qdd1, qdd2

    def forward(self, x, u):
        c1, s1, c2, s2, om1, om2 = (x[..., i] for i in range(6))
        tau = u[..., 0]
        if self.clamp_ctrl:
            tau = bclamp(tau, -self.max_torque, self.max_torque)
        qdd1, qdd2 = self._accelerations(
            self._split_params(), c1, s1, c2, s2, om1, om2, tau
        )
        nom1 = bclamp(om1 + self.dt * qdd1, -self.max_speed1, self.max_speed1)
        nom2 = bclamp(om2 + self.dt * qdd2, -self.max_speed2, self.max_speed2)
        th1 = jnp.arctan2(s1, c1) + self.dt * nom1
        th2 = jnp.arctan2(s2, c2) + self.dt * nom2
        return jnp.stack(
            [jnp.cos(th1), jnp.sin(th1), jnp.cos(th2), jnp.sin(th2),
             nom1, nom2],
            axis=-1,
        )

    def kernel_params(self):
        return self.params

    def entries_step(self, params, x_entries, u_entries):
        """Entry-wise (batch-minor) step for Pallas fusion: identical math
        to :meth:`forward` via the shared :meth:`_accelerations`, with the
        angle updates as rotation identities instead of ``arctan2``
        (kept out of the kernels — CLAUDE.md)."""
        c1, s1, c2, s2, om1, om2 = x_entries
        tau = u_entries[0]
        if self.clamp_ctrl:
            tau = bclamp(tau, -self.max_torque, self.max_torque)
        qdd1, qdd2 = self._accelerations(
            tuple(params), c1, s1, c2, s2, om1, om2, tau
        )
        nom1 = bclamp(om1 + self.dt * qdd1, -self.max_speed1, self.max_speed1)
        nom2 = bclamp(om2 + self.dt * qdd2, -self.max_speed2, self.max_speed2)

        def rotate(c, s, d):
            inv_r = jax.lax.rsqrt(c * c + s * s)
            c_hat, s_hat = c * inv_r, s * inv_r
            cd, sd = jnp.cos(d), jnp.sin(d)
            return c_hat * cd - s_hat * sd, s_hat * cd + c_hat * sd

        nc1, ns1 = rotate(c1, s1, self.dt * nom1)
        nc2, ns2 = rotate(c2, s2, self.dt * nom2)
        return [nc1, ns1, nc2, ns2, nom1, nom2]

    # grad_input: inherited exact autodiff (AUTO_DIFF == ANALYTIC under JAX).

    def get_true_obj(self, dtype=None):
        """Swing-up cost ingredients ``(q, p)``: quadratic weights toward
        the upright goal ``(1, 0, 1, 0, 0, 0)`` plus a control penalty."""
        if self.param_batch_shape:
            raise ValueError(
                "get_true_obj uses shared params; per-scenario costs go "
                "through the (T, B, ...) QuadCost contract directly"
            )
        dtype = dtype or self.params.dtype
        goal_weights = jnp.array([1.0, 1.0, 1.0, 1.0, 0.1, 0.1], dtype)
        goal_state = jnp.array([1.0, 0.0, 1.0, 0.0, 0.0, 0.0], dtype)
        ctrl_penalty = 0.001
        q = jnp.concatenate(
            [goal_weights, ctrl_penalty * jnp.ones(self.n_ctrl, dtype)]
        )
        p = jnp.concatenate(
            [-goal_weights * goal_state, jnp.zeros(self.n_ctrl, dtype)]
        )
        return q, p

    def get_frame(self, x, ax=None):
        """Render one matplotlib frame: the two links from the pivot."""
        import matplotlib.pyplot as plt
        import numpy as np

        if self.param_batch_shape:
            raise ValueError(
                "get_frame renders one instance; select a scenario row "
                "first: dx.replace(params=dx.params[b]).get_frame(x[b])"
            )
        x = np.asarray(x)
        th1 = float(np.arctan2(x[1], x[0]))
        th2 = float(np.arctan2(x[3], x[2]))
        l1, l2 = float(self.params[2]), float(self.params[3])
        if ax is None:
            _, ax = plt.subplots(figsize=(4, 4))
        x1, y1 = l1 * np.sin(th1), l1 * np.cos(th1)
        x2 = x1 + l2 * np.sin(th1 + th2)
        y2 = y1 + l2 * np.cos(th1 + th2)
        ax.plot([0.0, x1], [0.0, y1], color="k", lw=3)
        ax.plot([x1, x2], [y1, y2], color="b", lw=3)
        lim = 1.2 * (l1 + l2)
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        return ax
