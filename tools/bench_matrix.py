#!/usr/bin/env python
"""Benchmark matrix: one measurement per BASELINE.json configuration.

Prints one JSON line per row (plus the device line first):

1. SRCNN 9-1-5 single-image luma inference (1080p)
2. SRCNN 9-5-5 inference behind the on-device 2x bicubic pre-upscale
3. 100-epoch training run (SGD+momentum+weight-decay), 9-1-5; 3b in bf16
4. training with the on-device-degraded input pipeline
5. waifu2x-style 7-layer full-RGB upscaling (1080p)
6. serving batch: 8 540p luma frames per dispatch
7. serving batch: 4 540p RGB frames per dispatch
8. 100-epoch 9-5-5 training; 8b in bf16

Every row runs what ``api`` or ``trainer`` runs. Inference rows run at
f32 HIGHEST, which is the reference itself, so they carry no parity
gate. Training rows check finite parameters after the warmup dispatch;
the bf16 rows (3b, 8b) compute below f32 HIGHEST and additionally gate
their relative parameter drift against the HIGHEST parameters from the
same init and schedule. A failed gate refuses to publish the row and
the process exits nonzero.

Inference rows time a warmed, data-dependent ``lax.scan`` with
``block_until_ready``; training rows time ``train_loop`` after a warmup
run of the same dispatch shape. GPU only: with no GPU it exits nonzero.

``--json PATH`` additionally writes the whole matrix as one document.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

_ROWS: list[dict] = []
_PARITY_FAILED: list[str] = []


def _chained_bench(pipeline, img, iters=8, repeats=3):
    """Median seconds per iteration of a warmed, data-dependent scan."""
    from cnn_sr.utils.measure import time_scan

    return float(np.median(time_scan(pipeline, img, iters, repeats)[1]))


def _train_time(run, epochs=100):
    """Seconds per epoch of ``run(epochs)`` (it returns host arrays, so
    it has waited for the device)."""
    t0 = time.perf_counter()
    run(epochs)
    return (time.perf_counter() - t0) / epochs


def _emit(name, value, unit, extra="", parity=None):
    """Print + record one row; a failed parity gate drops the row."""
    row = {"metric": name, "value": round(value, 2), "unit": unit}
    if extra:
        row["note"] = extra
    if parity is not None:
        row.update(parity)
        if not parity["parity_ok"]:
            _PARITY_FAILED.append(name)
            print(f"# PARITY FAILURE on {name}: row NOT published "
                  f"({json.dumps(parity)})")
            return
    print(json.dumps(row), flush=True)
    _ROWS.append(row)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the full matrix as one JSON document")
    cli = ap.parse_args()
    import jax
    import jax.numpy as jnp

    from cnn_sr.utils.measure import nvidia_smi_line, require_gpu

    device = require_gpu()
    card = nvidia_smi_line()
    print(json.dumps({"device": device, "nvidia_smi": card}), flush=True)

    from cnn_sr.api import (_upscale_luma_batch_jit, _upscale_luma_jit,
                            _upscale_rgb_batch_jit, _upscale_rgb_jit)
    from cnn_sr.ops.resize import degrade, upscale_rgba
    from cnn_sr.training.samples import SampleSet
    from cnn_sr.training.trainer import init_train_state, train_loop
    from cnn_sr.utils.compile_cache import configure_compile_cache
    from cnn_sr.utils.config import parse_config, read_config
    from cnn_sr.utils.params_io import random_parameters

    configure_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(0)
    quiet = {"log": lambda *a: None}

    def classic_cfg(n1, n2, f1, f2, f3):
        return parse_config({
            "n1": n1, "n2": n2, "f1": f1, "f2": f2, "f3": f3,
            "momentum": 0.9, "weight_decay_parameter": 0.0001,
            "learning_rates": [1e-4, 1e-4, 1e-5],
            **{f"parameters_distribution_{i}": {
                "mean_w": 0.0, "mean_b": 0.0,
                "std_deviation_w": 0.005, "std_deviation_b": 0.0,
            } for i in (1, 2, 3)},
        })

    def jparams(cfg, seed=0):
        return jax.tree.map(jnp.asarray, random_parameters(
            cfg.layer_specs(), cfg.distributions, seed=seed))

    img = jnp.asarray(rng.integers(0, 256, (1080, 1920, 4), dtype=np.uint8))
    mpix = 1080 * 1920 / 1e6

    # --- 1: SRCNN 9-1-5 single-image luma inference (1080p) ---
    p915 = jparams(classic_cfg(64, 32, 9, 1, 5))
    dt = _chained_bench(lambda im: _upscale_luma_jit(p915, im), img)
    _emit("1_srcnn_9-1-5_1080p_inference", mpix / dt, "MPix/s")

    # --- 2: SRCNN 9-5-5 behind the on-device 2x pre-upscale ---
    p955 = jparams(classic_cfg(64, 32, 9, 5, 5))
    small = jnp.asarray(rng.integers(0, 256, (540, 960, 4), dtype=np.uint8))
    dt = _chained_bench(
        lambda im: _upscale_luma_jit(p955, upscale_rgba(im, 2.0)), small)
    _emit("2_srcnn_9-5-5_2x-upscaled-1080p", mpix / dt, "MPix/s",
          "includes the on-device 2x bicubic pre-upscale")

    # --- 3/3b: 100-epoch training (reference 36-sample 128^2 workload) ---
    def flat(st):
        return np.concatenate([np.asarray(a).ravel()
                               for l in st.params for a in (l["w"], l["b"])])

    def train_parity(st, ref_vec=None):
        vec = flat(st)
        p = {"parity_ok": bool(np.isfinite(vec).all())}
        if ref_vec is not None:
            rel = float(np.linalg.norm(vec - ref_vec)
                        / max(np.linalg.norm(ref_vec), 1e-12))
            p["parity_rel_drift_vs_f32"] = round(rel, 5)
            p["parity_ok"] = bool(p["parity_ok"] and rel < 5e-2)
        return p

    S, N = 36, 128
    samples = SampleSet(
        input_luma=rng.standard_normal((S, N, N, 1)).astype(np.float32),
        expected_luma=rng.uniform(0, 1, (S, N, N, 1)).astype(np.float32),
        width=N, height=N)
    kw = dict(validation_cadence=25, epochs_per_dispatch=25, **quiet)

    def train_rows(name, cfg, data, note):
        ref_vec = None
        for suffix, prec in (("", None), ("_bf16", "bf16")):
            state = init_train_state(cfg, seed=0)
            train_loop(cfg, data, state, epochs=25, seed=0, precision=prec,
                       **kw)  # warmup: compiles the 25-epoch dispatch
            par = train_parity(state, ref_vec)
            if prec is None:
                ref_vec = flat(state)
            dt = _train_time(lambda e: train_loop(
                cfg, data, state, epochs=e, seed=1, precision=prec, **kw))
            _emit(name + suffix, 1 / dt, "epochs/s",
                  f"{dt * 1e3:.2f} ms/epoch; {note}; "
                  f"{'bf16 mixed precision' if prec else 'f32 HIGHEST'}",
                  parity=par)

    train_rows("3_train_100_epochs_9-1-5", classic_cfg(64, 32, 9, 1, 5),
               samples, "reference 36x128^2 set")

    # --- 4: training with on-device-degraded inputs ---
    gts4 = jnp.asarray(rng.uniform(0, 1, (S, N, N)).astype(np.float32))
    t0 = time.perf_counter()
    ins4 = np.asarray(jax.jit(jax.vmap(lambda g: degrade(g, 2.0)))(gts4))
    prep_dt = time.perf_counter() - t0
    ins4 = ins4 - ins4.mean(axis=(1, 2), keepdims=True)
    samples4 = SampleSet(input_luma=ins4[..., None].astype(np.float32),
                         expected_luma=np.asarray(gts4)[..., None],
                         width=N, height=N)
    cfg = classic_cfg(64, 32, 9, 1, 5)
    state = init_train_state(cfg, seed=0)
    train_loop(cfg, samples4, state, epochs=25, seed=0, **kw)
    par = train_parity(state)
    dt = _train_time(lambda e: train_loop(cfg, samples4, state, epochs=e,
                                          seed=1, **kw))
    _emit("4_train_100_epochs_fused_input_pipeline", 1 / dt, "epochs/s",
          f"on-device degradation of the set took {prep_dt * 1e3:.0f} ms "
          "(first call, compile included)", parity=par)

    # --- 5: waifu2x-style 7-layer RGB upscaling (1080p) ---
    cfg7 = read_config(os.path.join(root, "configs", "waifu2x_7layer_rgb.json"))
    p7 = jparams(cfg7)
    dt = _chained_bench(lambda im: _upscale_rgb_jit(p7, im), img, iters=4)
    _emit("5_waifu2x_7layer_rgb_1080p", mpix / dt, "MPix/s")

    # --- 6/7: serving batches (tools/serve.py queue geometry) ---
    b8 = jnp.asarray(rng.integers(0, 256, (8, 540, 960, 4), dtype=np.uint8))
    dt = _chained_bench(lambda b: _upscale_luma_batch_jit(p955, b), b8)
    _emit("6_serving_batch8_540p", 8 * 540 * 960 / dt / 1e6, "MPix/s",
          "8-image 9-5-5 dispatch")
    dt = _chained_bench(lambda b: _upscale_rgb_batch_jit(p7, b), b8[:4],
                        iters=4)
    _emit("7_serving_rgb_batch4_540p", 4 * 540 * 960 / dt / 1e6, "MPix/s",
          "4-image waifu2x 7-layer dispatch")

    # --- 8/8b: 9-5-5 training on the same 36x128^2 workload ---
    train_rows("8_train_100_epochs_9-5-5", classic_cfg(64, 32, 9, 5, 5),
               samples, "reference 36x128^2 set")

    if cli.json:
        doc = {"device": device, "nvidia_smi": card,
               "date": time.strftime("%Y-%m-%d"), "rows": _ROWS}
        with open(cli.json, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"# wrote {cli.json}")

    if _PARITY_FAILED:
        print(f"# {len(_PARITY_FAILED)} row(s) refused on parity: "
              f"{', '.join(_PARITY_FAILED)}")
        sys.exit(1)


if __name__ == "__main__":
    main()
