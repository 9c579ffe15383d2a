#!/usr/bin/env python
"""Evaluate a trained model: PSNR(Y) over a directory of image pairs.

The BASELINE quality metric ("PSNR(Y) on Set5 within 0.05 dB") made
runnable: for each ``*_large/*_small`` pair (the training-sample format)
OR each plain image (degraded on the fly with the training degradation
model), run the net on the degraded image and report PSNR(Y) against the
ground truth — for bicubic (the degraded input itself) vs the network
output, per image and averaged.

Usage:
    python tools/evaluate.py -c cfg.json -i samples_dir
    python tools/evaluate.py -c cfg.json -i photos_dir --degrade 2
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="PSNR(Y) evaluation over an image set.")
    p.add_argument("--config", "-c", required=True)
    p.add_argument("--in-dir", "-i", required=True,
                   help="directory of *_large/*_small pairs, or plain images "
                   "when --degrade is given")
    p.add_argument("--degrade", "-d", type=float, default=None,
                   help="degrade plain images by this factor on the fly")
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    import jax.numpy as jnp

    from cnn_sr.api import upscale_image
    from cnn_sr.utils.compile_cache import configure_compile_cache
    from cnn_sr.ops.image import load_image
    from cnn_sr.ops.resize import degrade
    from cnn_sr.training.samples import find_training_samples
    from cnn_sr.training.trainer import init_train_state
    from cnn_sr.utils.config import read_config
    from cnn_sr.utils.metrics import psnr_y

    configure_compile_cache()
    cfg = read_config(args.config)
    state = init_train_state(cfg, seed=args.seed)

    if args.degrade:
        files = sorted(
            os.path.join(args.in_dir, f)
            for f in os.listdir(args.in_dir)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        pairs = []
        for f in files:
            gt = load_image(f)
            soft = np.asarray(
                jnp.clip(
                    jnp.round(
                        degrade(jnp.asarray(gt[..., :3], jnp.float32), args.degrade)
                    ), 0, 255,
                )
            ).astype(np.uint8)
            soft = np.dstack([soft, np.full(soft.shape[:2], 255, np.uint8)])
            pairs.append((os.path.basename(f), gt, soft))
    else:
        found = find_training_samples(args.in_dir)
        if not found:
            print("no image pairs found")
            return 1
        pairs = [
            (os.path.basename(lg), load_image(lg), load_image(sm))
            for lg, sm in found
        ]

    pad = cfg.total_padding() // 2
    bicubic_scores, net_scores = [], []
    print(f"{'image':<28} {'bicubic':>9} {'network':>9} {'delta':>8}")
    for name, gt, degraded in pairs:
        out = upscale_image(cfg, state.params, degraded)
        # compare only the center the net actually computed
        gt3 = gt[..., :3]
        c = (slice(pad, gt3.shape[0] - pad), slice(pad, gt3.shape[1] - pad))
        p_bi = psnr_y(degraded[..., :3][c], gt3[c])
        p_net = psnr_y(out[c], gt3[c])
        bicubic_scores.append(p_bi)
        net_scores.append(p_net)
        print(f"{name:<28} {p_bi:>8.2f} {p_net:>8.2f} {p_net - p_bi:>+8.2f}")

    print("-" * 58)
    mb, mn = np.mean(bicubic_scores), np.mean(net_scores)
    print(f"{'MEAN':<28} {mb:>8.2f} {mn:>8.2f} {mn - mb:>+8.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
