"""Device-mesh construction for multi-chip scaling.

The reference is single-process single-GPU (SURVEY.md §2.5); its only
parallelism is the batch NDRange axis. The generalization here is a
``jax.sharding.Mesh`` with named axes:

* ``"data"``  — batch/data parallelism (a gradient psum replaces the
  reference's atomic gradient accumulation);
* ``"spatial"`` — sharding the H×W plane of one large image across
  devices with halo exchange (``cnn_sr.parallel.spatial``), the image-domain
  analog of sequence/context parallelism.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_data: Optional[int] = None,
    n_spatial: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ``(data, spatial)`` mesh over the available devices.

    Defaults to all devices on the data axis. ``n_data * n_spatial`` must
    not exceed the device count; excess devices are left unused.
    """
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_spatial
    needed = n_data * n_spatial
    if needed > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_spatial} needs {needed} devices, "
            f"only {len(devices)} available"
        )
    grid = np.asarray(devices[:needed]).reshape(n_data, n_spatial)
    return Mesh(grid, axis_names=("data", "spatial"))
