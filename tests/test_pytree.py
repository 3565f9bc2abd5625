"""The frozen-dataclass pytree helper (diffmpc_tpu/utils/pytree.py) that the
models are built on."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from diffmpc_tpu.models import NNDynamics, PendulumDx
from diffmpc_tpu.utils import pytree


@pytree.dataclass
class _Box:
    w: jnp.ndarray
    scale: float = pytree.field(pytree_node=False, default=2.0)


def test_data_fields_are_leaves_and_meta_fields_are_static():
    box = _Box(jnp.ones(3))
    leaves, treedef = jax.tree_util.tree_flatten(box)
    assert len(leaves) == 1 and leaves[0].shape == (3,)
    # meta fields live in the treedef: a different value is another tree
    other = jax.tree_util.tree_structure(_Box(jnp.ones(3), scale=3.0))
    assert treedef != other

    @jax.jit
    def f(b):
        return b.w * b.scale  # static: a Python float inside the trace

    assert float(jnp.sum(f(box))) == 6.0


def test_replace_and_frozen():
    box = _Box(jnp.zeros(2))
    new = box.replace(w=jnp.ones(2))
    assert float(jnp.sum(new.w)) == 2.0 and new.scale == box.scale
    with pytest.raises(dataclasses.FrozenInstanceError):
        box.w = jnp.ones(2)


@pytest.mark.parametrize("make", [
    lambda: PendulumDx.default(jnp.float32),
    lambda: NNDynamics.init(jax.random.PRNGKey(0), 3, 1, hidden=(4,)),
])
def test_models_roundtrip_through_tree_map(make):
    """Models flow through tree_map / grad as pytrees, statics untouched."""
    dx = make()
    doubled = jax.tree_util.tree_map(lambda a: 2 * a, dx)
    assert type(doubled) is type(dx)
    for a, b in zip(jax.tree_util.tree_leaves(dx), jax.tree_util.tree_leaves(doubled)):
        assert jnp.allclose(2 * a, b)
    meta = [f.name for f in dataclasses.fields(dx) if not f.metadata.get("pytree_node", True)]
    assert all(getattr(doubled, k) == getattr(dx, k) for k in meta)
