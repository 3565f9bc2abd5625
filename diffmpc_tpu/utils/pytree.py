"""Frozen dataclass pytrees with static metadata fields.

The models are frozen dataclasses whose array fields flow through
``jit``/``grad``/``vmap``/``shard_map`` as pytree children, while fields
declared ``field(pytree_node=False)`` (step sizes, limits, dimensions)
are static metadata. Built on ``jax.tree_util.register_dataclass``.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def dataclass(cls):
    """Make ``cls`` a frozen dataclass registered as a pytree, with a
    ``replace(**changes)`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
