"""Measuring on the accelerator: which device, and how long.

Every number this repository reports is a device number, so measuring
code starts with ``require_gpu`` (no CPU fallback: a run that finds no
GPU fails) and prints ``nvidia_smi_line`` beside its results, because a
card set below its maximum power limit runs slower under load.
``time_scan`` times device work the same way for every caller.
"""

from __future__ import annotations

import subprocess
import time

import jax


def require_gpu() -> dict:
    """The ``{"platform", "kind", "count"}`` of JAX's devices; exits
    nonzero unless the first device is a GPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"needs a GPU; JAX found {devices[0].platform} "
            f"({devices[0].device_kind})")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def nvidia_smi_line() -> str:
    """``name, power.limit`` of each card exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (one line per card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def time_scan(fn, x, iters: int, repeats: int):
    """Time ``fn`` run ``iters`` times as one data-dependent
    ``lax.scan``: each iteration's input carries the centre element of
    the previous output (a centre element, because image borders pass
    through the nets untouched and XLA would drop the work behind
    them). Returns the first call's seconds (compilation included) and
    the seconds per iteration of each of ``repeats`` warm runs, each
    ended by ``block_until_ready``."""

    @jax.jit
    def chained(c):
        def body(c, _):
            out = fn(c)
            centre = out[tuple(s // 2 for s in out.shape)]
            return c.at[(0,) * c.ndim].set(centre.astype(c.dtype)), ()

        return jax.lax.scan(body, c, None, length=iters)[0]

    t0 = time.perf_counter()
    jax.block_until_ready(chained(x))
    first = time.perf_counter() - t0
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(chained(x))
        runs.append((time.perf_counter() - t0) / iters)
    return first, runs
