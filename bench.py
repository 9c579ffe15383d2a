"""Benchmark: single-image upscaling throughput on the flagship config.

Times SRCNN 9-5-5 (n1=64, n2=32) luma upscaling of a 1920x1080 frame
through the program ``api.upscale_image`` runs (uint8 RGBA on the
device → luma pipeline → 3 convs at f32 HIGHEST → swap-luma → uint8
RGB on the device). The frames run as a data-dependent ``lax.scan``
(``utils.measure.time_scan``), warmed once, and timed with
``block_until_ready``.

Runs on a GPU only: with no GPU it exits nonzero and prints no result.
Prints ONE JSON line: the throughput, ms per frame, the device as JAX
reports it, and the card's name and power limit from nvidia-smi.

Env knob: BENCH_ITERS (frames per scan, default 20). The median of 5
timed scans is reported.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

REPEATS = 5  # timed scans; the median is reported


def main():
    import jax
    import jax.numpy as jnp

    from cnn_sr.utils.measure import nvidia_smi_line, require_gpu, time_scan

    device = require_gpu()

    from __graft_entry__ import _flagship
    from cnn_sr.api import _upscale_luma_jit
    from cnn_sr.utils.compile_cache import configure_compile_cache
    from cnn_sr.utils.params_io import random_parameters

    configure_compile_cache()
    iters = int(os.environ.get("BENCH_ITERS", "20"))
    h, w = 1080, 1920

    cfg = _flagship()
    params = jax.tree.map(jnp.asarray, random_parameters(
        cfg.layer_specs(), cfg.distributions, seed=0))
    rgba = jax.device_put(np.random.default_rng(0).integers(
        0, 256, (h, w, 4), dtype=np.uint8))

    compile_s, times = time_scan(
        lambda img: _upscale_luma_jit(params, img), rgba, iters, REPEATS)
    dt = float(np.median(times))

    print(json.dumps({
        "metric": "srcnn_9-5-5_1080p_upscale_throughput",
        "value": round(h * w / dt / 1e6, 2),
        "unit": "MPix/s",
        "ms_per_frame": round(dt * 1e3, 4),
        "ms_per_frame_runs": [round(t * 1e3, 4) for t in times],
        "first_call_s": round(compile_s, 2),
        "precision": "f32 HIGHEST",
        "device": device,
        "nvidia_smi": nvidia_smi_line(),
    }))


if __name__ == "__main__":
    main()
