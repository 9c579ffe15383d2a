#!/usr/bin/env python
"""Smoke test of the whole system on one GPU: upscaling, training and
serving through the entry points a user calls, at the full widths of
the shipped models, each checked against the plain f32 reference.

    python chip_smoke.py            # phases a-f on one GPU
    python chip_smoke.py --multi    # the four-GPU phase only

Phases (one process; every phase runs, and any failure exits nonzero
without the final ``ok`` line):

a. forward, flagship: ``cli.main`` upscales a seeded 1920x1080 RGBA PNG
   with ``configs/srcnn_9-5-5_pretrained.json``; a 256x256 centre crop
   must match ``models.forward`` at ``Precision.HIGHEST`` computed on
   the CPU device in this process: float luma |d| <= 1e-4 of the
   output's peak, uint8 |d| <= 1 (the two devices sum f32 products in
   another order; HIGHEST keeps the GPU's products out of TF32).
b. forward, the other configs: the 7-layer RGB stack on 960x540 and
   SRCNN 9-1-5 on 1920x1080 (random weights at std 0.05, so that its
   output is far from zero), same checks.
c. precision and formulation timings of the flagship 1080p frame,
   printed, not gated: ms/frame and the uint8 parity verdict against
   HIGHEST for f32 HIGHEST, HIGH, DEFAULT (TF32 here), bf16 operands
   with f32 accumulation, ``fast_forward`` in bf16 and the byte-packed colour
   ends.
d. train: seeded synthetic sample pairs (36 crops of 128x128, the
   repository's stand-in for the reference's 36-sample set, degraded
   by ``ops.resize`` on the device) written as PNG; ``cli.main train``
   runs 50 epochs at HIGHEST (finite parameters, validation MSE falls)
   and 10 each at ``--train-precision bf16`` and ``default``; the
   parameter update of one HIGHEST epoch must match the same epoch's
   update on the CPU device within 1e-4 of its norm.
e. serve: ``tools/serve.make_server`` in this process on a free port
   answers 2 luma and 1 RGB request, each bit-identical to
   ``api.upscale_image``.
f. memory: ``peak_bytes_in_use`` and ``memory_analysis()`` of the
   flagship forward and the training step.

``--multi`` (4 GPUs): ``cnn.py --spatial-shard 4`` on a 3840x2160 frame
against one GPU, the data-parallel train step on a 4-way ``data`` mesh
against one device (1e-5 relative), ``train --data-parallel 4`` through
the CLI, and the composed 2x2 data x spatial mesh.

Before the phases it prints the card's name and power limit, the JAX
versions and the compile-cache directory; the last line is one JSON
object ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs", "srcnn_9-5-5_pretrained.json")
RGB = os.path.join(ROOT, "configs", "waifu2x_7layer_rgb_pretrained.json")
SRCNN_915 = os.path.join(ROOT, "configs", "srcnn_9-1-5.json")
SRCNN_955 = os.path.join(ROOT, "configs", "srcnn_9-5-5.json")


class SmokeFailure(AssertionError):
    """A phase's check did not hold."""


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def _frame(rng, h: int, w: int) -> np.ndarray:
    """Seeded uint8 RGBA frame: smooth colour fields plus noise, so the
    nets see edges and texture rather than pure noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = []
    for _ in range(3):
        fy, fx, ph = rng.uniform(0.005, 0.08, 2).tolist() + [rng.uniform(0, 6)]
        chans.append(128 + 90 * np.sin(fy * yy + ph) * np.cos(fx * xx))
    rgb = np.stack(chans, -1) + rng.normal(0, 12, (h, w, 3))
    alpha = np.full((h, w, 1), 255.0)
    return np.clip(np.concatenate([rgb, alpha], -1), 0, 255).astype(np.uint8)


def _cli(argv, log) -> str:
    """Run ``cli.main`` with its output captured; raise on nonzero."""
    from cnn_sr.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        log(buf.getvalue()[-3000:])
        raise SmokeFailure(f"cli {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def _params(cfg_path: str, seed: int):
    """The parameters the CLI uses for ``cfg_path`` with ``--seed``."""
    from cnn_sr.training.trainer import init_train_state
    from cnn_sr.utils.config import read_config

    cfg = read_config(cfg_path)
    return cfg, init_train_state(cfg, seed=seed).params


def widened_config(cfg_path: str, workdir: str, std: float = 0.05) -> str:
    """A copy of a config without a checkpoint whose random weights have
    standard deviation ``std``. The shipped 9-1-5 initialisation (std
    0.005) gives outputs near 5e-5, where a wrong or all-zero output
    would pass any parity bound."""
    with open(cfg_path) as f:
        raw = json.load(f)
    i = 1
    while f"parameters_distribution_{i}" in raw:
        raw[f"parameters_distribution_{i}"]["std_deviation_w"] = std
        i += 1
    name = os.path.splitext(os.path.basename(cfg_path))[0]
    out = os.path.join(workdir, f"{name}_std{std:g}.json")
    with open(out, "w") as f:
        json.dump(raw, f)
    return out


def _reference_window(cfg, params, rgba, r0, c0, crop, device):
    """Net output and uint8 RGB of the ``crop`` x ``crop`` output window
    at (r0, c0), computed on ``device`` with ``models.forward`` at
    HIGHEST. The mean is the whole image's, as in the full pipeline."""
    import jax
    import jax.numpy as jnp

    from cnn_sr.models import forward
    from cnn_sr.ops.color import (extract_luma, subtract_mean, swap_luma,
                                  swap_rgb)

    pad = cfg.total_padding() // 2
    win = (slice(r0 - pad, r0 + crop + pad), slice(c0 - pad, c0 + crop + pad))
    with jax.default_device(device):
        p = jax.device_put(params, device)
        img = jax.device_put(rgba, device)
        if cfg.channels == 1:
            luma = extract_luma(img, normalize=True)
            luma0, mean = subtract_mean(luma, squared=cfg.subtract_squared_mean)
            y = forward(p, luma0[win][None, ..., None])[0, ..., 0]
            if cfg.zero_mean_target:
                y = y + mean
            rgb = swap_luma(img[win], y)
        else:
            x = img[..., :3].astype(jnp.float32) / 255.0
            mean = jnp.mean(x, axis=(0, 1), keepdims=True)
            y = forward(p, (x - mean)[win][None])[0]
            if cfg.zero_mean_target:
                y = y + mean
            rgb = swap_rgb(img[win], y)
        return (np.asarray(y),
                np.asarray(rgb)[pad:pad + crop, pad:pad + crop])


def _device_net_output(cfg, params, rgba):
    """The full frame's net output on the default device (HIGHEST)."""
    import jax
    import jax.numpy as jnp

    from cnn_sr.models import forward
    from cnn_sr.ops.color import extract_luma, subtract_mean

    @jax.jit
    def net(p, img):
        if cfg.channels == 1:
            luma0, mean = subtract_mean(extract_luma(img, normalize=True),
                                        squared=cfg.subtract_squared_mean)
            y = forward(p, luma0[None, ..., None])[0, ..., 0]
        else:
            x = img[..., :3].astype(jnp.float32) / 255.0
            mean = jnp.mean(x, axis=(0, 1), keepdims=True)
            y = forward(p, (x - mean)[None])[0]
        return y + mean if cfg.zero_mean_target else y

    return np.asarray(net(jax.tree.map(jnp.asarray, params), rgba))


def phase_forward(cfg_path: str, height: int, width: int, seed: int,
                  workdir: str, crop: int = 256, log=print) -> dict:
    """Phases a and b: upscale a seeded frame through ``cli.main`` and
    compare a centre crop with the HIGHEST reference on the CPU."""
    import jax

    from cnn_sr.ops.image import load_image
    from cnn_sr.ops.png import encode_png

    cfg, params = _params(cfg_path, seed)
    rgba = _frame(np.random.default_rng(seed), height, width)
    name = os.path.splitext(os.path.basename(cfg_path))[0]
    src = os.path.join(workdir, f"{name}_in.png")
    dst = os.path.join(workdir, f"{name}_out.png")
    with open(src, "wb") as f:
        f.write(encode_png(rgba))
    t0 = time.perf_counter()
    _cli(["-c", cfg_path, "-i", src, "-o", dst, "--seed", str(seed)], log)
    cli_s = time.perf_counter() - t0
    out = load_image(dst)[..., :3]
    _check(out.shape == (height, width, 3), f"output shape {out.shape}")

    pad = cfg.total_padding() // 2
    r0, c0 = (height - crop) // 2, (width - crop) // 2
    y_ref, rgb_ref = _reference_window(cfg, params, rgba, r0, c0, crop,
                                       jax.devices("cpu")[0])
    y_dev = _device_net_output(cfg, params, rgba)[
        r0 - pad:r0 - pad + crop, c0 - pad:c0 - pad + crop]
    _check(bool(np.isfinite(y_dev).all()), "non-finite net output")
    luma_d = float(np.abs(y_dev - y_ref).max())
    peak = float(np.abs(y_ref).max())
    u8_d = int(np.abs(out[r0:r0 + crop, c0:c0 + crop].astype(int)
                      - rgb_ref.astype(int)).max())
    res = {"config": name, "frame": f"{width}x{height}",
           "cli_first_call_s": round(cli_s, 2),
           "float_max_abs_diff": luma_d,
           "float_max_abs_value": peak,
           "uint8_max_abs_diff": u8_d}
    log(f"forward {json.dumps(res)}")
    # relative to the output's peak, so an output stuck near zero fails
    _check(luma_d <= 1e-4 * peak, f"{name}: float |d| {luma_d} > 1e-4 * {peak}")
    _check(u8_d <= 1, f"{name}: uint8 |d| {u8_d} > 1")
    return res


def _bf16_forward(params, x):
    """bf16 operands, f32 accumulation and f32 bias/ReLU."""
    import jax.numpy as jnp
    from jax import lax

    y = x
    last = len(params) - 1
    for i, layer in enumerate(params):
        y = lax.conv_general_dilated(
            y.astype(jnp.bfloat16), layer["w"].astype(jnp.bfloat16),
            (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32) + layer["b"]
        if i != last:
            y = jnp.maximum(y, 0.0)
    return y


def phase_precision(cfg_path: str, height: int, width: int, seed: int,
                    iters: int = 10, card: str = "", log=print) -> list:
    """Phase c: ms/frame and uint8 parity against HIGHEST of each
    precision and formulation on the flagship frame (not gated)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from cnn_sr.api import _upscale_luma_packed_jit
    from cnn_sr.models import forward
    from cnn_sr.models.fast_forward import fast_forward
    from cnn_sr.ops.color import (extract_luma, pack_rgba_host,
                                  subtract_mean, swap_luma, unpack_rgb_host)
    from cnn_sr.utils.measure import time_scan
    from cnn_sr.utils.metrics import uint8_parity

    cfg, params = _params(cfg_path, seed)
    params = jax.tree.map(jnp.asarray, params)
    rgba = jnp.asarray(_frame(np.random.default_rng(seed), height, width))
    packed = jnp.asarray(pack_rgba_host(np.asarray(rgba)))

    def pipeline(fwd):
        def run(img):
            luma0, mean = subtract_mean(extract_luma(img, normalize=True),
                                        squared=cfg.subtract_squared_mean)
            y = fwd(params, luma0[None, ..., None])[0, ..., 0]
            return swap_luma(img, y + mean if cfg.zero_mean_target else y)
        return run

    def packed_run(u32):
        return _upscale_luma_packed_jit(
            params, u32, add_mean=cfg.zero_mean_target,
            squared_mean=cfg.subtract_squared_mean)

    variants = [
        ("f32_highest", pipeline(forward), rgba),
        ("f32_high", pipeline(
            lambda p, x: forward(p, x, precision=lax.Precision.HIGH)), rgba),
        ("f32_default_tf32", pipeline(
            lambda p, x: forward(p, x, precision=lax.Precision.DEFAULT)), rgba),
        ("bf16_operands_f32_acc", pipeline(_bf16_forward), rgba),
        ("fast_forward_bf16", pipeline(fast_forward), rgba),
        ("packed_io_f32_highest", packed_run, packed),
    ]
    ref = np.asarray(jax.jit(variants[0][1])(rgba))
    rows = []
    for name, fn, img in variants:
        out = np.asarray(jax.jit(fn)(img))
        if out.ndim == 2:  # packed uint32 pixels
            out = unpack_rgb_host(out)
        ms = float(np.median(time_scan(fn, img, iters, 3)[1])) * 1e3
        row = {"variant": name, "frame": f"{width}x{height}",
               "ms_per_frame": round(ms, 4),
               "mpix_per_s": round(height * width / ms / 1e3, 2),
               **uint8_parity(out, ref), "card": card}
        log(f"precision {json.dumps(row)}")
        rows.append(row)
    return rows


def _write_samples(dirpath: str, seed: int, count: int, size: int) -> None:
    """Seeded sample pairs: ``size``-square crops of synthetic frames,
    degraded 2x by ``ops.resize.degrade`` on the default device."""
    import jax
    import jax.numpy as jnp

    from cnn_sr.ops.png import encode_png
    from cnn_sr.ops.resize import degrade

    rng = np.random.default_rng(seed)
    large = np.stack([_frame(rng, size, size)[..., :3]
                      for _ in range(count)])
    small = jax.jit(jax.vmap(lambda im: degrade(im, 2.0)))(
        jnp.asarray(large, jnp.float32))
    small = np.clip(np.round(np.asarray(small)), 0, 255).astype(np.uint8)
    os.makedirs(dirpath, exist_ok=True)
    for i in range(count):
        for tag, arr in (("large", large[i]), ("small", small[i])):
            with open(os.path.join(dirpath, f"s{i:03d}_{tag}.png"), "wb") as f:
                f.write(encode_png(arr))


def _flat(params) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for l in params for a in (l["w"], l["b"])])


def phase_train(cfg_path: str, workdir: str, seed: int, count: int = 36,
                size: int = 128, epochs: int = 50, short_epochs: int = 10,
                log=print) -> dict:
    """Phase d: CLI training at each precision, validation MSE falling,
    and one HIGHEST epoch against the CPU device."""
    import jax

    from cnn_sr.training.samples import find_training_samples, load_sample_set
    from cnn_sr.training.trainer import init_train_state, train_loop
    from cnn_sr.utils.config import read_config
    from cnn_sr.utils.params_io import load_parameters_file

    cfg = read_config(cfg_path)
    sdir = os.path.join(workdir, "samples")
    _write_samples(sdir, seed, count, size)

    res = {"samples": f"{count}x{size}x{size}"}
    for prec, n in (("highest", epochs), ("bf16", short_epochs),
                    ("default", short_epochs)):
        out = os.path.join(workdir, f"params_{prec}.json")
        t0 = time.perf_counter()
        text = _cli(["train", "-c", cfg_path, "-i", sdir, "-e", str(n),
                     "-o", out, "--seed", str(seed),
                     "--train-precision", prec], log)
        wall = time.perf_counter() - t0
        vals = [float(v) for v in
                re.findall(r"mean validation error: (\S+)", text)]
        params, _ = load_parameters_file(out, cfg.layer_specs())
        _check(bool(np.isfinite(_flat(params)).all()),
               f"{prec}: non-finite parameters")
        _check(len(vals) >= 2 and all(np.isfinite(vals)),
               f"{prec}: validation errors {vals}")
        res[prec] = {"epochs": n, "wall_s_incl_compile": round(wall, 2),
                     "val_mse": vals}
        if prec == "highest":
            _check(vals[-1] < vals[0], f"validation MSE did not fall: {vals}")

    samples = load_sample_set(find_training_samples(sdir))

    def one_epoch_update(device):
        """The change one HIGHEST epoch makes to the parameters."""
        with jax.default_device(device):
            state = init_train_state(cfg, seed=seed)
            before = _flat(state.params)
            train_loop(cfg, samples, state, 1, seed=seed, log=lambda *a: None)
        return _flat(state.params) - before

    dev = one_epoch_update(jax.devices()[0])
    cpu = one_epoch_update(jax.devices("cpu")[0])
    # relative to the CPU's update, not to the parameters: an update that
    # is missing on the device gives 1, whatever the initial values
    norm = float(np.linalg.norm(cpu))
    rel = float(np.linalg.norm(dev - cpu) / norm)
    res["one_epoch_update_norm"] = norm
    res["one_epoch_update_rel_err_vs_cpu"] = rel
    log(f"train {json.dumps(res)}")
    _check(norm > 0, "one epoch left the parameters unchanged on the CPU")
    _check(rel <= 1e-4, f"one epoch's update vs CPU: rel {rel} > 1e-4")
    return res


def phase_serve(requests, seed: int, log=print) -> dict:
    """Phase e: serve ``requests`` ((slot, config, height, width)
    tuples) in this process; each answer must equal ``upscale_image``."""
    from cnn_sr.api import upscale_image
    from cnn_sr.ops.image import decode_image_bytes
    from cnn_sr.ops.png import encode_png
    from tools.serve import load_slot, make_server

    slots = {}
    for slot, cfg_path, _, _ in requests:
        slots.setdefault(slot, load_slot(cfg_path, seed=seed))
    server, worker = make_server(slots, port=0)
    worker.start()
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    host, port = server.server_address[:2]
    rng = np.random.default_rng(seed)
    res = []
    try:
        for slot, _, h, w in requests:
            rgba = _frame(rng, h, w)
            req = urllib.request.Request(
                f"http://{host}:{port}/upscale?model={slot}",
                data=encode_png(rgba), headers={"Content-Type": "image/png"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                got = decode_image_bytes(r.read())[..., :3]
            dt = time.perf_counter() - t0
            want = upscale_image(slots[slot]["cfg"], slots[slot]["params"], rgba)
            same = bool(np.array_equal(got, want))
            res.append({"slot": slot, "frame": f"{w}x{h}", "equal": same,
                        "request_s_incl_compile": round(dt, 3)})
            log(f"serve {json.dumps(res[-1])}")
            _check(same, f"served {slot} {w}x{h} differs from upscale_image")
    finally:
        server.shutdown()
        server.server_close()
        worker.stop()
        worker.join(timeout=60)
    return {"requests": res}


def phase_memory(cfg_path: str, height: int, width: int, train_cfg: str,
                 count: int, size: int, log=print) -> dict:
    """Phase f: compiled memory of the flagship forward and the training
    step, and the device's peak bytes in use so far."""
    import jax
    import jax.numpy as jnp

    from cnn_sr.api import _upscale_luma_jit
    from cnn_sr.training.trainer import init_train_state, make_train_step
    from cnn_sr.utils.config import read_config

    def analysis(compiled):
        m = compiled.memory_analysis()
        return {k: int(getattr(m, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(m, k)}

    cfg, params = _params(cfg_path, 0)
    params = jax.tree.map(jnp.asarray, params)
    fwd = _upscale_luma_jit.lower(
        params, jax.ShapeDtypeStruct((height, width, 4), jnp.uint8),
        add_mean=cfg.zero_mean_target,
        squared_mean=cfg.subtract_squared_mean).compile()
    tcfg = read_config(train_cfg)
    st = init_train_state(tcfg, seed=0)
    t = count - int(count * 20 / 100)  # the CLI's 20% validation split
    batch = jax.ShapeDtypeStruct((t, size, size, 1), jnp.float32)
    step = make_train_step(tcfg).lower(
        jax.tree.map(jnp.asarray, st.params),
        jax.tree.map(jnp.asarray, st.prev_delta), batch, batch).compile()
    stats = jax.devices()[0].memory_stats() or {}
    res = {"forward_1080p": analysis(fwd), "train_step": analysis(step),
           "train_batch": list(batch.shape),
           "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
           "bytes_limit": stats.get("bytes_limit")}
    log(f"memory {json.dumps(res)}")
    return res


def phase_multi(seed: int, workdir: str, height: int = 2160,
                width: int = 3840, log=print) -> dict:
    """The four-device phase: spatial sharding through the CLI, the
    data-parallel train step, CLI data-parallel training and the
    composed 2x2 mesh, each against one device."""
    import jax
    import jax.numpy as jnp

    from cnn_sr.models import forward
    from cnn_sr.ops.image import load_image
    from cnn_sr.ops.png import encode_png
    from cnn_sr.parallel.mesh import make_mesh
    from cnn_sr.parallel.spatial import sharded_forward
    from cnn_sr.training.trainer import init_train_state, make_train_step
    from cnn_sr.utils.config import read_config

    devices = jax.devices()
    _check(len(devices) >= 4, f"--multi needs 4 devices, found {len(devices)}")
    res = {}

    # spatial halo exchange through the CLI, against one device
    rgba = _frame(np.random.default_rng(seed), height, width)
    src = os.path.join(workdir, "frame4k.png")
    with open(src, "wb") as f:
        f.write(encode_png(rgba))
    outs = {}
    for shards in (0, 4):
        dst = os.path.join(workdir, f"frame4k_sr{shards}.png")
        _cli(["-c", FLAGSHIP, "-i", src, "-o", dst, "--spatial-shard",
              str(shards)], log)
        outs[shards] = load_image(dst)[..., :3].astype(int)
    d = np.abs(outs[4] - outs[0])
    res["spatial_4"] = {"frame": f"{width}x{height}", "uint8_max_abs_diff":
                        int(d.max()), "pixels_differing": int((d > 0).sum())}
    log(f"multi {json.dumps(res['spatial_4'])}")
    _check(d.max() <= 1, f"spatial-shard 4: uint8 |d| {d.max()} > 1")

    # data-parallel train step on a 4-way data mesh, against one device
    cfg = read_config(SRCNN_955)
    rng = np.random.default_rng(seed)
    inputs = jnp.asarray(rng.standard_normal((8, 64, 64, 1)), jnp.float32)
    gts = jnp.asarray(rng.uniform(0, 1, (8, 64, 64, 1)), jnp.float32)

    def step(mesh):
        st = init_train_state(cfg, seed=seed)
        p, _ = make_train_step(cfg, mesh=mesh)(
            jax.tree.map(jnp.asarray, st.params),
            jax.tree.map(jnp.asarray, st.prev_delta), inputs, gts)
        return _flat(p)

    one = step(None)

    def rel(v):
        return float(np.linalg.norm(v - one) / np.linalg.norm(one))

    res["data_parallel_4_rel"] = rel(step(make_mesh(n_data=4,
                                                    devices=devices[:4])))
    cmesh = make_mesh(n_data=2, n_spatial=2, devices=devices[:4])
    res["composed_2x2_train_rel"] = rel(step(cmesh))
    _, params = _params(FLAGSHIP, seed)
    x = jnp.asarray(rng.standard_normal((1, 512, 256, 1)), jnp.float32)
    y2 = np.asarray(sharded_forward(cmesh, jax.tree.map(jnp.asarray, params), x))
    y1 = np.asarray(jax.jit(forward)(jax.tree.map(jnp.asarray, params), x))
    res["composed_2x2_forward_max_abs_diff"] = float(np.abs(y2 - y1).max())

    # data-parallel training through the CLI (20 samples: 16 train, 4 val)
    sdir = os.path.join(workdir, "dp_samples")
    _write_samples(sdir, seed, 20, 64)
    _cli(["train", "-c", SRCNN_955, "-i", sdir, "-e", "4", "-o",
          os.path.join(workdir, "dp.json"), "--data-parallel", "4",
          "--seed", str(seed)], log)
    log(f"multi {json.dumps(res)}")
    _check(res["data_parallel_4_rel"] <= 1e-5, "data-parallel step differs")
    _check(res["composed_2x2_train_rel"] <= 1e-5, "2x2 train step differs")
    _check(res["composed_2x2_forward_max_abs_diff"] <= 1e-4,
           "2x2 spatial forward differs")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="GPU smoke test (see module doc)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 1

    sys.path.insert(0, ROOT)
    import jaxlib

    from cnn_sr.utils.compile_cache import configure_compile_cache
    from cnn_sr.utils.measure import nvidia_smi_line

    card = nvidia_smi_line()
    print(card)
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"compile cache: {configure_compile_cache()}", flush=True)

    def log(msg):
        print(msg, flush=True)

    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.multi:
            phases = [("multi", lambda: phase_multi(args.seed, work, log=log))]
        else:
            phases = [
                ("a", lambda: phase_forward(FLAGSHIP, 1080, 1920, args.seed,
                                            work, log=log)),
                ("b", lambda: [
                    phase_forward(RGB, 540, 960, args.seed, work, log=log),
                    phase_forward(widened_config(SRCNN_915, work), 1080,
                                  1920, args.seed, work, log=log)]),
                ("c", lambda: phase_precision(FLAGSHIP, 1080, 1920, args.seed,
                                              card=card, log=log)),
                ("d", lambda: phase_train(SRCNN_955, work, args.seed, log=log)),
                ("e", lambda: phase_serve(
                    [("default", FLAGSHIP, 1080, 1920),
                     ("default", FLAGSHIP, 1080, 1920),
                     ("rgb", RGB, 540, 960)], args.seed, log=log)),
                ("f", lambda: phase_memory(FLAGSHIP, 1080, 1920, SRCNN_955,
                                           36, 128, log=log)),
            ]
        for name, run in phases:
            t0 = time.perf_counter()
            try:
                run()
                log(f"PHASE {name} ok ({time.perf_counter() - t0:.1f} s)")
            except Exception:  # noqa: BLE001 — report every phase, then fail
                traceback.print_exc()
                log(f"PHASE {name} FAILED ({time.perf_counter() - t0:.1f} s)")
                failed.append(name)
    if failed:
        print(f"chip_smoke: phases failed: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
