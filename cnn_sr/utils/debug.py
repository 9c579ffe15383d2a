"""Debug helpers: array dumps and blocking-transfer detection.

Equivalents of the reference's debug machinery:

* ``dump_vector``/``print_array`` ≙ cnn_sr::utils::dump_vector
  (pch.cpp:29-54) and DataPipeline::print_buffer (DataPipeline.cpp:98-115)
  — formatted float dumps with per-line counts and line numbers;
* ``warn_blocking_transfers`` ≙ the global
  ``warn_about_blocking_operation`` flag (pch.cpp:16) that logs every
  host-blocking call — here a context manager around
  ``jax.transfer_guard("log")``, which makes JAX log every implicit
  device↔host transfer inside the scope (an accelerator's notion of a
  blocking operation). The CLI's ``profile`` mode wraps the run in it.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np


def dump_vector(data, per_line: int = 8, line_numbers: bool = True,
                prefix: str = "") -> str:
    """Format a float array as comma-separated lines."""
    arr = np.asarray(data).ravel()
    lines = []
    for start in range(0, arr.size, per_line):
        chunk = arr[start : start + per_line]
        head = f"{prefix}[{start // per_line}] " if line_numbers else prefix
        lines.append(head + ", ".join(f"{float(v):.6g}" for v in chunk))
    return "\n".join(lines)


def print_array(name: str, arr, log=print, sample: int = 16) -> None:
    """Shape/stats summary + a value sample for a device or host array."""
    a = np.asarray(arr)
    log(
        f"{name}: shape={tuple(a.shape)} dtype={a.dtype} "
        f"min={a.min():.6g} max={a.max():.6g} mean={a.mean():.6g} "
        f"finite={np.isfinite(a).all()}"
    )
    log(dump_vector(a.ravel()[:sample], prefix="  "))


@contextlib.contextmanager
def warn_blocking_transfers(enabled: bool = True):
    """Log every implicit device↔host transfer inside the scope."""
    if not enabled:
        yield
        return
    import jax

    with jax.transfer_guard("log"):
        yield
