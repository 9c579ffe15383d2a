#!/usr/bin/env python
"""Generate paired training samples from a directory of images.

Equivalent of the reference's generate_training_samples.py:14-74 — this
script IS the degradation model the network learns to invert:

* for each input image: take a random ``out_size``² crop →
  ``sample_N_large.jpg`` (the ground truth);
* downscale the crop by ``--degrade-factor`` and upscale back to
  ``out_size`` with a high-quality resampler (Lanczos, PIL's successor
  to the deprecated ANTIALIAS) → ``sample_N_small.jpg`` (the degraded
  input). The net learns small-luma → large-luma.

Usage:
    python tools/generate_training_samples.py -i raw_dir -o samples_dir -s 128 -d 2
    python tools/generate_training_samples.py --synthetic 256 -o samples_dir -s 96 -d 3

``--synthetic N`` generates N procedural source images instead of
reading ``--in-dir`` — the environment-independent way to produce a
training set (used to train the committed ``pretrained/`` checkpoint;
no image dataset ships with the repo). Images are gradient backgrounds
with anti-aliased shapes/strokes at all orientations, drawn at 4x and
Lanczos-downscaled so edges carry natural partial-pixel coverage.
"""

from __future__ import annotations

import argparse
import math
import os
import random
import sys

from PIL import Image, ImageDraw


def _degrade_pil(large, out_size, degrade_factor):
    small_size = max(1, int(out_size / degrade_factor))
    small = large.resize((small_size, small_size), Image.LANCZOS)
    return small.resize((out_size, out_size), Image.LANCZOS)


def _degrade_jax(large, out_size, degrade_factor):
    """On-device degradation via the framework's jitted resize ops
    (ops/resize.degrade) — the 'input pipeline fused on-device' variant."""
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax.numpy as jnp

    from cnn_sr.ops.resize import degrade

    arr = jnp.asarray(np.asarray(large), jnp.float32)
    soft = degrade(arr, degrade_factor, method="lanczos")
    out = np.clip(np.round(np.asarray(soft)), 0, 255).astype("uint8")
    return Image.fromarray(out, "RGB")


def _value_noise(rng, big, octaves=3, base=8):
    """Multi-octave value noise in [0, 1]: coarse random grids
    bicubic-upscaled and summed with 1/2^o weights — band-limited
    texture with natural-image-like spectral falloff (the reference
    README's own weak cases are textures and smooth gradients,
    README.md:16-20; pure shape/gradient data never teaches them)."""
    import numpy as np

    acc = np.zeros((big, big), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        g = base * (2 ** o)
        coarse = rng.random((g, g), np.float32)
        up = np.asarray(
            Image.fromarray((coarse * 255).astype(np.uint8), "L")
            .resize((big, big), Image.BICUBIC), np.float32) / 255.0
        acc += amp * up
        total += amp
        amp *= 0.5
    return acc / total


def synth_image(rng, size: int = 256) -> Image.Image:
    """Procedural RGB image: smooth gradient background + band-limited
    texture fields + anti-aliased ellipses, rotated rectangles and
    strokes at random orientations (shapes randomly texture-filled).

    Deterministic given ``rng`` (a ``numpy.random.Generator``). Edge
    density and orientation coverage are what SRCNN's receptive field
    learns from; drawing at 4x and Lanczos-downscaling gives edges
    natural partial-pixel coverage instead of binary staircases. The
    texture octaves target the reference's documented weak cases
    (textures/gradients — README.md:16-20): degrade-then-restore on
    band-limited texture is exactly the deconvolution problem natural
    photos pose."""
    import numpy as np

    big = size * 4
    xx = np.arange(big, dtype=np.float32)[None, :] / big
    yy = np.arange(big, dtype=np.float32)[:, None] / big
    chans = []
    for _ in range(3):
        a, b, c = rng.uniform(-1.0, 1.0, 3)
        th = rng.uniform(0.0, 2.0 * math.pi)
        freq = rng.uniform(0.5, 3.0)
        g = (
            0.55
            + 0.22 * (a * xx + b * yy)
            + 0.18 * c * np.sin(
                2.0 * math.pi * freq
                * (xx * math.cos(th) + yy * math.sin(th))
            )
        )
        chans.append(g)
    arr = np.clip(np.stack(chans, axis=-1), 0.0, 1.0)
    # background texture: a value-noise field modulating all channels
    # (amplitude varies per image; some images stay near-smooth so the
    # smooth-gradient regime remains represented)
    tex_amp = float(rng.uniform(0.0, 0.35))
    if tex_amp > 0.02:
        tex = _value_noise(rng, big, octaves=int(rng.integers(2, 5)),
                           base=int(rng.integers(6, 14)))
        arr = np.clip(arr + tex_amp * (tex - 0.5)[..., None], 0.0, 1.0)
    im = Image.fromarray(np.round(arr * 255.0).astype(np.uint8), "RGB")
    draw = ImageDraw.Draw(im)
    # textured shape fills: drawn on a separate layer and composited
    # through the shape mask with per-shape texture amplitude
    n_tex_shapes = int(rng.integers(0, 5))
    for _ in range(n_tex_shapes):
        color = np.asarray(rng.integers(0, 256, 3), np.float32)
        x0, y0 = (int(v) for v in rng.integers(0, big, 2))
        w, h = (int(v) for v in rng.integers(big // 16, big // 2, 2))
        mask = Image.new("L", (big, big), 0)
        mdraw = ImageDraw.Draw(mask)
        if int(rng.integers(0, 2)):
            mdraw.ellipse([x0, y0, x0 + w, y0 + h], fill=255)
        else:
            mdraw.rectangle([x0, y0, x0 + w, y0 + h], fill=255)
        t = _value_noise(rng, big, octaves=3,
                         base=int(rng.integers(8, 20)))
        amp = float(rng.uniform(0.2, 0.8))
        fill = np.clip(
            color[None, None] * (1.0 - amp + amp * 2.0 * t[..., None]),
            0, 255).astype(np.uint8)
        im.paste(Image.fromarray(fill, "RGB"), (0, 0), mask)
    for _ in range(int(rng.integers(12, 30))):
        kind = int(rng.integers(0, 3))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        if kind == 0:  # ellipse
            x0, y0 = (int(v) for v in rng.integers(0, big, 2))
            w, h = (int(v) for v in rng.integers(big // 32, big // 3, 2))
            draw.ellipse([x0, y0, x0 + w, y0 + h], fill=color)
        elif kind == 1:  # rotated rectangle
            cx, cy = (float(v) for v in rng.integers(0, big, 2))
            w, h = (float(v) for v in rng.integers(big // 32, big // 3, 2))
            th = rng.uniform(0.0, math.pi)
            ct, st = math.cos(th), math.sin(th)
            pts = [
                (cx + ct * dx - st * dy, cy + st * dx + ct * dy)
                for dx, dy in [(-w, -h), (w, -h), (w, h), (-w, h)]
            ]
            draw.polygon(pts, fill=color)
        else:  # stroke
            x0, y0, x1, y1 = (int(v) for v in rng.integers(0, big, 4))
            draw.line(
                [x0, y0, x1, y1], fill=color,
                width=int(rng.integers(2, max(3, big // 48))),
            )
    return im.resize((size, size), Image.LANCZOS)


def make_pair(large, out_dir, img_id, degrade_factor, backend="pil",
              fmt="jpg"):
    """Write one ``sample_<id>_large/_small`` pair from a square RGB
    crop (the degradation model itself — see module docstring)."""
    out_size = large.width
    large_path = os.path.join(out_dir, f"sample_{img_id}_large.{fmt}")
    small_path = os.path.join(out_dir, f"sample_{img_id}_small.{fmt}")
    large.save(large_path)
    if backend == "jax":
        small = _degrade_jax(large, out_size, degrade_factor)
    else:
        small = _degrade_pil(large, out_size, degrade_factor)
    small.save(small_path)
    return large_path, small_path


def process_image(in_path, out_dir, img_id, out_size, degrade_factor, rng,
                  backend="pil", fmt="jpg"):
    with Image.open(in_path) as im:
        if im.width < out_size or im.height < out_size:
            raise ValueError(
                f"Image '{os.path.basename(in_path)}' is smaller than the "
                f"requested out-size {out_size}"
            )
        x = rng.randint(0, im.width - out_size)
        y = rng.randint(0, im.height - out_size)
        large = im.convert("RGB").crop((x, y, x + out_size, y + out_size))

    return make_pair(large, out_dir, img_id, degrade_factor,
                     backend=backend, fmt=fmt)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Create paired *_large/*_small training samples by "
        "cropping and degrade-resampling input images."
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--in-dir", "-i", default=None, help="input directory")
    src.add_argument("--synthetic", type=int, default=None, metavar="N",
                     help="generate N procedural source images instead of "
                     "reading --in-dir (deterministic with --seed)")
    p.add_argument("--out-dir", "-o", required=True, help="output directory")
    p.add_argument("--out-size", "-s", required=True, type=int,
                   help="size of output (square) samples")
    p.add_argument("--degrade-factor", "-d", type=float, default=2,
                   help="downscale factor used to produce the degraded image")
    p.add_argument("--seed", type=int, default=None,
                   help="RNG seed: crop positions (--in-dir mode) or all "
                   "procedural content + crops (--synthetic mode)")
    p.add_argument("--backend", choices=["pil", "jax"], default="pil",
                   help="degradation backend: PIL (host) or the framework's "
                   "on-device jitted resize")
    p.add_argument("--format", choices=["jpg", "png"], default=None,
                   dest="fmt",
                   help="sample file format: jpg (reference parity) or png "
                   "(lossless — JPEG ringing on edge-dense content puts an "
                   "unlearnable-noise floor under training). Default: jpg "
                   "for --in-dir, png for --synthetic (whose edge-dense "
                   "content hits that floor hard — docs/TRAINING.md)")
    args = p.parse_args(argv)

    if args.fmt is None:
        args.fmt = "png" if args.synthetic is not None else "jpg"
    os.makedirs(args.out_dir, exist_ok=True)

    created = []
    if args.synthetic is not None:
        import numpy as np

        nprng = np.random.default_rng(args.seed)
        src_size = max(256, args.out_size)
        for img_id in range(args.synthetic):
            im = synth_image(nprng, src_size)
            x = int(nprng.integers(0, src_size - args.out_size + 1))
            y = int(nprng.integers(0, src_size - args.out_size + 1))
            large = im.crop((x, y, x + args.out_size, y + args.out_size))
            created.append(
                make_pair(large, args.out_dir, img_id, args.degrade_factor,
                          backend=args.backend, fmt=args.fmt)
            )
    else:
        rng = random.Random(args.seed)
        files = sorted(
            f for f in os.listdir(args.in_dir)
            if os.path.isfile(os.path.join(args.in_dir, f))
        )
        for img_id, name in enumerate(files):
            try:
                created.append(
                    process_image(
                        os.path.join(args.in_dir, name), args.out_dir,
                        img_id, args.out_size, args.degrade_factor, rng,
                        backend=args.backend, fmt=args.fmt,
                    )
                )
            except (OSError, ValueError) as e:
                print(f"cannot create train samples for '{name}': {e}")

    if not created:
        print("No files were created")
        return 1
    print(f"created {len(created)} sample pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
