"""Device-mesh and sharding helpers.

The reference has no distributed layer at all (SURVEY.md §2.3 — single
process, batch vectorization only). The scaling story is built here
instead: the scenario batch axis is sharded over a 1-D ``('batch',)`` mesh
with ``NamedSharding``; XLA's GSPMD partitioner inserts the collectives
(``psum`` for gradient reductions, which XLA hands to NCCL over NVLink
between the cards of a host). No hand-written transport layer is needed
(SURVEY.md §5.8).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"


def make_mesh(devices: Optional[Sequence] = None, axis: str = BATCH_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices, named for the batch axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def batch_sharding(mesh: Mesh, batch_dim: int = 0, ndim: int = 2) -> NamedSharding:
    """NamedSharding placing ``batch_dim`` on the mesh axis, rest replicated.

    MPC trajectory tensors are ``(T, B, ...)`` — batch_dim=1; per-scenario
    tensors like ``x_init`` are ``(B, ...)`` — batch_dim=0.
    """
    spec = [None] * ndim
    spec[batch_dim] = BATCH_AXIS
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree, batch_dim: int = 0):
    """Device-put every array in ``tree`` with its batch axis sharded."""

    def put(x):
        return jax.device_put(x, batch_sharding(mesh, batch_dim, np.ndim(x)))

    return jax.tree_util.tree_map(put, tree)


def replicate(mesh: Mesh, tree):
    """Device-put every array replicated on the mesh (params, configs)."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, replicated(mesh)), tree
    )


def gather_results(tree):
    """Collect sharded solve results to host numpy arrays — the all_gather
    result-collection step of SURVEY.md §5.8. Single-host: a device_get;
    multi-host: a cross-host allgather of each process's addressable
    shards."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        tree = multihost_utils.process_allgather(tree, tiled=True)
    return jax.device_get(tree)
