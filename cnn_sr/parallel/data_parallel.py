"""Data-parallel sharding helpers.

Annotation-driven SPMD: the batch axis of sample arrays is sharded over
the mesh's ``"data"`` axis, parameters are replicated, and XLA inserts
the gradient all-reduce (psum) during ``jax.jit`` compilation of the
train step — the replacement for the reference's
atomic-add gradient accumulation across its sample NDRange axis
(backpropagate.cl:110-112, SURVEY.md §2.5).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def shard_batch(mesh: Mesh, arr):
    """Place an (S, H, W, C) array with S sharded over the "data" axis.
    S must be divisible by the data-axis size."""
    return jax.device_put(arr, NamedSharding(mesh, P("data")))


def replicate(mesh: Mesh, tree):
    """Fully replicate a pytree (parameters / optimizer state) on the mesh."""
    s = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, s), tree)
