"""Spatial (halo-exchange) sharding: one large image across many chips.

The image-domain analog of sequence/context parallelism (SURVEY.md §5):
the H axis of an (N, H, W, C) image is sharded over the mesh's
``"spatial"`` axis. Valid convs need ``shrink = Σ(f_i − 1)`` extra rows
below each shard, so every device fetches a halo of its successor's top
rows with ONE ``lax.ppermute`` before running the full conv
stack locally — communication is a single neighbor exchange of
``shrink · W · C`` floats regardless of depth, because the halo covers
the whole stack's receptive field at once.

The last shard has no successor; ppermute delivers zeros there, and the
rows computed from them are sliced off (the global output has only
``H − shrink`` valid rows anyway).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..models import forward


def sharded_forward(mesh: Mesh, params, x: jnp.ndarray) -> jnp.ndarray:
    """Run the model over ``x`` with H sharded on the "spatial" mesh axis.

    Requires ``H % n_spatial == 0`` and a shard height ≥ the stack's
    total shrink (so one neighbor's halo suffices).
    Returns the (N, H − shrink, W − shrink, C_out) output, replicated
    row-sharded like the input.
    """
    shrink = sum(layer["w"].shape[0] - 1 for layer in params)
    n_spatial = mesh.shape["spatial"]
    h = x.shape[1]
    if h % n_spatial != 0:
        raise ValueError(f"image height {h} not divisible by spatial axis {n_spatial}")
    rows = h // n_spatial
    if rows < shrink:
        raise ValueError(
            f"shard height {rows} smaller than receptive-field shrink {shrink}"
        )

    def local(params, xb):
        # pull the successor's top `shrink` rows (zeros at the last shard)
        perm = [(i + 1, i) for i in range(n_spatial - 1)]
        halo = lax.ppermute(xb[:, :shrink], "spatial", perm)
        ext = jnp.concatenate([xb, halo], axis=1)
        return forward(params, ext)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(None, "spatial", None, None)),
        out_specs=P(None, "spatial", None, None),
        check_vma=False,
    )
    y = fn(params, x)
    # drop the trailing rows computed from the zero halo of the last shard
    return y[:, : h - shrink]
