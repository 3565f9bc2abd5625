"""Shared helpers for the imitation-learning example CLIs (ref C8).

Importing this module ALSO bootstraps ``sys.path`` so the examples run from
a clean shell (``python examples/il_pendulum.py ...``) without an installed
package or a manually exported PYTHONPATH — every example imports ``common``
before ``diffmpc_tpu`` for exactly this reason — and points the persistent
compilation cache at ``<repo>/.jax_cache`` unless
``JAX_COMPILATION_CACHE_DIR`` names another directory.
"""

from __future__ import annotations

import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import numpy as np
import jax
import jax.numpy as jnp

from diffmpc_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()


def force_cpu_if_requested(args):
    if getattr(args, "cpu", False):
        jax.config.update("jax_platforms", "cpu")


def random_pendulum_x_init(B, seed=0, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    thdot = rng.uniform(-1.0, 1.0, B)
    return jnp.asarray(np.stack([np.cos(th), np.sin(th), thdot], -1), dtype)


def random_cartpole_x_init(B, seed=0, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.5, 0.5, B)
    pdot = rng.uniform(-0.5, 0.5, B)
    th = rng.uniform(-0.3, 0.3, B)  # near upright (stabilization task)
    thdot = rng.uniform(-0.5, 0.5, B)
    return jnp.asarray(
        np.stack([p, pdot, np.cos(th), np.sin(th), thdot], -1), dtype
    )


def random_acrobot_x_init(B, seed=0, dtype=jnp.float32, scale=0.05):
    """Near-upright perturbations (the balance task — the upright pole is
    ~7 rad/s unstable, see AcrobotDx's docstring)."""
    rng = np.random.default_rng(seed)
    th1 = rng.uniform(-scale, scale, B)
    th2 = rng.uniform(-scale, scale, B)
    return jnp.asarray(
        np.stack(
            [
                np.cos(th1), np.sin(th1), np.cos(th2), np.sin(th2),
                rng.uniform(-scale, scale, B),
                rng.uniform(-scale, scale, B),
            ],
            -1,
        ),
        dtype,
    )


def random_vehicle_x_init(B, seed=0, dtype=jnp.float32, py_scale=1.0):
    """Lane-keeping starts: lateral offset + heading error at speed."""
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        np.stack(
            [
                np.zeros(B),
                rng.uniform(-py_scale, py_scale, B),
                rng.uniform(-0.3, 0.3, B),
                rng.uniform(3.0, 7.0, B),
            ],
            -1,
        ),
        dtype,
    )
