"""The ``cnn`` command-line application.

CLI parity with the reference (Main_cl.cpp:40-115):

* bare-word mode flags: ``train`` (training mode), ``dry`` (don't write
  outputs), ``profile`` (print per-stage execution times);
* valued options: ``-c/--config`` (required), ``-i/--in`` (image for
  forward mode, samples directory for training), ``-o/--out`` (result
  image or new parameters file), ``-e/--epochs``;
* out path is required unless ``dry`` (Main_cl.cpp:66-69);
* forward mode: decode → luma pipeline → net → swap-luma → encode
  (execute_forward, Main_cl.cpp:217-241);
* training mode: sample discovery, per-epoch shuffled 20% validation
  split, NaN abort (exit 1), params written at the end
  (Main_cl.cpp:115-210).

Knobs the reference hardcodes are exposed as optional flags with the
reference's values as defaults: ``--validation-percent`` (20),
``--mini-batch-count`` (2), ``--validation-cadence`` (25). Extensions:
``--scale`` (fused on-device pre-upscale), ``--bucket`` (shape bucketing for the compile
cache), ``--epochs-per-dispatch`` (scanned multi-epoch dispatch),
``--trace-dir`` (op-level profiler traces), ``--seed``, forward mode
over a whole directory of images, and multi-device SPMD:
``--spatial-shard N`` (halo-exchange row sharding of one image) and
``--data-parallel N`` (batch sharding with XLA gradient all-reduce).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cnn",
        description="SRCNN super-resolution in JAX: train or upscale.",
    )
    p.add_argument("-c", "--config", required=True, help="CNN configuration file")
    p.add_argument(
        "-i", "--in", dest="in_path", required=True,
        help="image (forward) or samples directory (training)",
    )
    p.add_argument(
        "-o", "--out", dest="out_path", default=None,
        help="output path (result image or new parameters file)",
    )
    p.add_argument(
        "-e", "--epochs", type=int, default=0, help="number of training epochs"
    )
    p.add_argument("--validation-percent", type=int, default=20)
    p.add_argument("--mini-batch-count", type=int, default=2)
    p.add_argument("--validation-cadence", type=int, default=25)
    p.add_argument(
        "--epochs-per-dispatch", type=int, default=8,
        help="fuse this many epochs into one device dispatch (lax.scan); "
        "semantically identical to per-epoch dispatch",
    )
    p.add_argument("--seed", type=int, default=None, help="deterministic RNG seed")
    p.add_argument(
        "--full-state", action="store_true",
        help="also save/resume momentum buffers + shuffle RNG in a "
        "'<params>.state.npz' sidecar, making interrupted training "
        "bit-identical to an uninterrupted run (the reference's params "
        "JSON alone resets momentum on resume)",
    )
    p.add_argument(
        "--train-precision", choices=("highest", "high", "default", "bf16"),
        default="highest",
        help="conv precision of the training step: 'highest' is true f32, "
        "exact reference parity (default); 'high' and 'default' run f32 "
        "convs in TF32 on Hopper GPUs (about 1e-3 relative error per "
        "product); 'bf16' is mixed-precision training (bf16 "
        "forward/backward, f32 master weights and gradient accumulation)",
    )
    p.add_argument(
        "--scale", type=float, default=1.0,
        help="upscale the input on-device by this factor before the net "
        "(the reference requires pre-upscaled input; this fuses that step)",
    )
    p.add_argument(
        "--bucket", type=int, default=0,
        help="pad image shapes up to multiples of this so the conv program "
        "compiles once per bucket (identical results; recommended 64 for "
        "directories of mixed sizes; 0 = exact shapes)",
    )
    p.add_argument(
        "--trace-dir", default=None,
        help="capture a jax.profiler trace into this directory "
        "(op-level timeline for TensorBoard/Perfetto)",
    )
    p.add_argument(
        "--spatial-shard", type=int, default=0, metavar="N",
        help="forward: split the image's rows over N devices (-1 = all) "
        "with one halo exchange per image (ppermute); results are "
        "identical to single-device",
    )
    p.add_argument(
        "--data-parallel", type=int, default=0, metavar="N",
        help="training: shard the sample batch over N devices (-1 = all) "
        "on a 'data' mesh axis; XLA inserts the gradient all-reduce. "
        "The train and validation split sizes must divide by N",
    )
    p.add_argument(
        "--packed-io", dest="packed_io", action="store_true", default=None,
        help="forward: run the color ends on uint32 byte-packed pixels "
        "(a dense 2D image instead of a rank-3 one; output is "
        "bit-identical). Default follows the library; unbucketed "
        "single-image path only",
    )
    p.add_argument(
        "--no-packed-io", dest="packed_io", action="store_false",
        help="force the rank-3 uint8 color ends",
    )
    return p


def _resolve_devices(n: int) -> int:
    """-1 → all available devices; validates n ≥ 1 otherwise."""
    import jax

    avail = len(jax.devices())
    if n == -1:
        return avail
    if n < 1 or n > avail:
        raise SystemExit(f"need 1..{avail} devices, got {n}")
    return n


def _forward_one(args, cfg, params, rgba):
    """Dispatch one image through the selected forward path."""
    if args.spatial_shard:
        from .api import upscale_image_spatial

        return upscale_image_spatial(
            cfg, params, rgba, _resolve_devices(args.spatial_shard))
    from .api import upscale_image

    kw = {}
    if getattr(args, "packed_io", None) is not None:
        kw["packed_io"] = args.packed_io
    return upscale_image(cfg, params, rgba, bucket=args.bucket, **kw)


def run_forward(args, cfg, profiler) -> int:
    import os

    from .ops.image import load_image, write_image
    from .training.trainer import init_train_state

    # training treats a missing parameters file as "train from scratch"
    # (reference semantics); forward mode with random weights only ever
    # produces garbage — fail loudly instead
    if cfg.parameters_file and not os.path.isfile(cfg.parameters_file):
        print(f"Parameters file not found: '{cfg.parameters_file}' "
              "(forward mode needs trained weights)")
        return 1

    state = init_train_state(cfg, seed=args.seed)

    if os.path.isdir(args.in_path):
        return _run_forward_dir(args, cfg, state, profiler)

    with profiler.stage("load_image"):
        rgba = load_image(args.in_path)
    print(f"Input image: {args.in_path}, size: {rgba.shape[1]}x{rgba.shape[0]}")

    if args.scale != 1.0:
        import numpy as _np

        from .ops.resize import upscale_rgba

        rgba = profiler.timed(
            "upscale_input (bicubic)",
            lambda: _np.asarray(upscale_rgba(rgba, args.scale)),
        )
        print(f"Pre-scaled by {args.scale}x to {rgba.shape[1]}x{rgba.shape[0]}")

    out = profiler.timed(
        "upscale (jit: luma+forward+swap)",
        _forward_one, args, cfg, state.params, rgba,
    )

    if args.out_path:
        with profiler.stage("write_image"):
            write_image(args.out_path, out)
        print(f"Output written: {args.out_path}")
    return 0


def _run_forward_dir(args, cfg, state, profiler) -> int:
    """Forward mode over a directory: upscale every image (an extension —
    the reference is single-image only). Same-shaped images share one
    compiled program."""
    import os

    import numpy as np

    from .ops.image import load_image, write_image

    files = sorted(
        f for f in os.listdir(args.in_path)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    if not files:
        print(f"no images found in '{args.in_path}'")
        return 1
    if args.out_path:
        os.makedirs(args.out_path, exist_ok=True)

    for name in files:
        with profiler.stage("load_image"):
            rgba = load_image(os.path.join(args.in_path, name))
        if args.scale != 1.0:
            from .ops.resize import upscale_rgba

            rgba = np.asarray(upscale_rgba(rgba, args.scale))
        out = profiler.timed("upscale", _forward_one, args, cfg,
                             state.params, rgba)
        if args.out_path:
            stem = os.path.splitext(name)[0]
            dst = os.path.join(args.out_path, f"{stem}_sr.png")
            with profiler.stage("write_image"):
                write_image(dst, out)
            print(f"{name} -> {dst}")
        else:
            print(f"{name}: upscaled {out.shape[1]}x{out.shape[0]} (dry)")
    return 0


def run_training(args, cfg, profiler) -> int:
    from .training.samples import find_training_samples, load_sample_set
    from jax import lax

    from .training.trainer import init_train_state, train_loop

    _LAX_PRECISION = {"high": lax.Precision.HIGH,
                      "default": lax.Precision.DEFAULT,
                      "bf16": "bf16"}  # trainer sentinel: mixed precision
    from .utils.params_io import save_parameters_file

    print(
        f"Training mode, epochs: {args.epochs}\n"
        f"Training samples directory: {args.in_path}\n"
        f"Output: {args.out_path or '-'}"
    )
    with profiler.stage("load_samples"):
        pairs = find_training_samples(args.in_path)
        samples = load_sample_set(pairs, channels=cfg.channels,
                                  zero_mean_target=cfg.zero_mean_target,
                                  squared_mean=cfg.subtract_squared_mean)
    print(f"Loaded {samples.count} samples of {samples.width}x{samples.height}")

    state = init_train_state(cfg, seed=args.seed)

    rng = None
    if args.full_state:
        from .training.checkpoint import load_full_state

        if cfg.parameters_file:
            rng = load_full_state(cfg.parameters_file, state)
            if rng is not None:
                print(f"Resumed full training state "
                      f"(momentum + RNG) from "
                      f"'{cfg.parameters_file}.state.npz'")
        if rng is None:
            rng = np.random.default_rng(args.seed)

    mesh = None
    if args.data_parallel:
        from .parallel.mesh import make_mesh

        n = _resolve_devices(args.data_parallel)
        v = int(samples.count * args.validation_percent / 100.0)
        t = samples.count - v
        if t % n or (v and v % n):
            raise SystemExit(
                f"--data-parallel {n}: train split {t} and validation "
                f"split {v} must both divide by the device count")
        mesh = make_mesh(n_data=n)
        print(f"Data-parallel training over {n} devices "
              f"(batch axis sharded; gradient psum across devices)")

    t0 = time.perf_counter()
    with profiler.stage("train_loop"):
        error = train_loop(
            cfg,
            samples,
            state,
            args.epochs,
            validation_percent=args.validation_percent,
            mini_batch_count=args.mini_batch_count,
            validation_cadence=args.validation_cadence,
            epochs_per_dispatch=args.epochs_per_dispatch,
            mesh=mesh,
            precision=(None if args.train_precision == "highest"
                       else _LAX_PRECISION[args.train_precision]),
            seed=args.seed,
            rng=rng,
        )
    dt = time.perf_counter() - t0
    if args.epochs > 0:
        print(
            f"Training time: {dt:.3f}s ({dt / args.epochs:.5f} s/epoch, "
            f"{args.epochs / dt:.2f} epochs/s)"
        )

    if args.out_path and not error:
        print(f"Saving parameters to: '{args.out_path}'")
        save_parameters_file(args.out_path, state.params, epochs=state.epochs)
        if args.full_state:
            from .training.checkpoint import save_full_state

            print(f"Saving full training state to: "
                  f"'{save_full_state(args.out_path, state, rng)}'")
    return 1 if error else 0


_MODE_WORDS = {"train", "dry", "profile"}
# options that consume a value: their following token is never a mode word
_VALUED_OPTS = {
    "-c", "--config", "-i", "--in", "-o", "--out", "-e", "--epochs",
    "--validation-percent", "--mini-batch-count", "--validation-cadence",
    "--seed", "--scale", "--epochs-per-dispatch", "--bucket", "--trace-dir",
}


def _split_modes(argv: List[str]):
    """Extract bare-word mode flags (train/dry/profile) from anywhere in
    the argument list, like the reference's Argparse positional flags
    (pch.cpp:183-376) — e.g. ``cnn train dry -c cfg -i dir profile``."""
    modes, rest = set(), []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in _VALUED_OPTS and i + 1 < len(argv):
            rest.extend(argv[i : i + 2])
            i += 2
        elif tok in _MODE_WORDS:
            modes.add(tok)
            i += 1
        else:
            rest.append(tok)
            i += 1
    return modes, rest


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    modes, rest = _split_modes(list(argv))
    args = build_parser().parse_args(rest)
    train = "train" in modes
    dry = "dry" in modes
    profile = "profile" in modes

    if not dry and not args.out_path:
        print("Either provide out path or do the dry run")
        return 1
    if dry:
        args.out_path = None
    if profile:
        print("!!! RUNNING IN PROFILING MODE !!!")

    from .profiling import StageProfiler, print_device_memory, report_op_shares
    from .utils.config import ConfigError, read_config

    # profile mode always captures an op-level trace: into --trace-dir if
    # given (kept for TensorBoard/Perfetto), else a temp dir consumed by
    # the ranked per-op table below (reference profile.py:9-18 UX)
    trace_dir = args.trace_dir
    if profile and not trace_dir:
        import tempfile

        trace_dir = tempfile.mkdtemp(prefix="cnnsr_trace_")
    profiler = StageProfiler(enabled=profile, profile_dir=trace_dir)

    try:
        cfg = read_config(args.config)
    except FileNotFoundError:
        print(f"Config file not found: '{args.config}'")
        return 1
    except ConfigError as e:
        print(f"Invalid config: {e}")
        return 1
    print(cfg)

    from .utils.debug import warn_blocking_transfers

    try:
        profiler.start_trace()
        # profile mode also logs every implicit device<->host transfer —
        # the reference's warn_about_blocking_operation flag (pch.cpp:16)
        with warn_blocking_transfers(enabled=profile):
            if train:
                rc = run_training(args, cfg, profiler)
            else:
                rc = run_forward(args, cfg, profiler)
    except FileNotFoundError as e:
        print(f"File not found: {e}")
        return 1
    except ValueError as e:
        print(f"Error: {e}")
        return 1
    finally:
        profiler.stop_trace()
        profiler.report()
        if profile:
            report_op_shares(trace_dir)
            print_device_memory()
    if rc == 0:
        print("DONE")
    return rc


if __name__ == "__main__":
    sys.exit(main())
