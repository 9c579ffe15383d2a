"""Multi-host (multi-process) initialization helpers.

The reference has no distributed story (SURVEY.md §2.5). Here the
framework scales past one host the standard JAX way: one process per
host, ``jax.distributed.initialize`` wires the PJRT clients together,
and every mesh built by ``parallel.mesh.make_mesh`` then spans all
hosts' devices — the data-parallel train step and spatial sharding work
unchanged, with XLA routing the collectives between hosts.

Host-local data feeding uses ``jax.make_array_from_process_local_data``
so each host only loads its own shard of the sample set.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the JAX distributed runtime. Returns True if the
    distributed service was (or already had been) initialized.

    MUST run before any JAX call that touches the backend (device
    queries, array creation, jit execution) — ``jax.distributed``
    requires an uninitialized XLA client. A no-op returning False when
    neither explicit arguments nor a cluster environment
    (COORDINATOR_ADDRESS / JAX_COORDINATOR_ADDRESS) is present. Pass
    the arguments explicitly where no cluster manager sets them.
    """
    has_env = any(
        v in os.environ
        for v in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"))
    if coordinator_address is None and num_processes is None and not has_env:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    except RuntimeError as e:
        # two benign cases: already initialized (idempotent call), or the
        # backend was touched first (caller ordering bug — surface it)
        if "already" in str(e).lower():
            return True
        raise


def shard_host_local_batch(mesh, arr):
    """Build a global batch-sharded array from this process's local
    samples (each host contributes its slice of the batch axis)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("data"))
    return jax.make_array_from_process_local_data(sharding, arr)
