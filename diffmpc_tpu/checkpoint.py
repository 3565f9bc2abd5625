"""Checkpoint / resume of training state as ``.npz`` files.

Capability parity: the reference's Chainer ``serializers.save_npz /
load_npz`` of model params in examples (SURVEY.md §5.4). The learnable
params + optimizer state pytree is saved as its flattened leaves under
``path/step_<N>/state.npz``; the caller's ``like`` pytree gives the
structure back at restore. Solver state is stateless per step (warm
starts travel as explicit ``u_init`` carries, like the reference's
``prev_ctrl``).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

_FILE = "state.npz"


def save_checkpoint(path: str, state: Any, step: int, keep: int = 3) -> str:
    """Save a pytree ``state`` under ``path/step_<N>``; prunes old steps."""
    path = os.path.abspath(path)
    ckpt_dir = os.path.join(path, f"step_{step}")
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]
    tmp = os.path.join(ckpt_dir, "tmp_" + _FILE)
    with open(tmp, "wb") as fh:
        np.savez(fh, *leaves)
    os.replace(tmp, os.path.join(ckpt_dir, _FILE))

    steps = sorted(_steps(path))
    for old in steps[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{old}"), ignore_errors=True)
    return ckpt_dir


def _steps(path: str):
    return [
        int(d.split("_", 1)[1])
        for d in os.listdir(path)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
    ]


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = _steps(path)
    return max(steps) if steps else None


def restore_checkpoint(path: str, like: Any, step: Optional[int] = None) -> Any:
    """Restore the pytree saved at ``path/step_<N>`` (latest by default),
    with ``like`` providing the target structure and dtypes."""
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    like_leaves, treedef = jax.tree_util.tree_flatten(like)
    with np.load(os.path.join(path, f"step_{step}", _FILE)) as data:
        saved = [data[f"arr_{i}"] for i in range(len(data.files))]
    if len(saved) != len(like_leaves):
        raise ValueError(
            f"checkpoint step {step} holds {len(saved)} arrays; the target "
            f"structure has {len(like_leaves)} leaves"
        )
    leaves = [
        jnp.asarray(s, dtype=jnp.asarray(l).dtype)
        for s, l in zip(saved, like_leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, leaves)
