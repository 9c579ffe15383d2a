"""On-device image scaling (the pipeline's degradation/upscale model).

The reference keeps scaling OUT of process: images must be pre-upscaled
(e.g. 2x bicubic) before `cnn` sees them, and the training degradation
(downscale + upscale back) lives in generate_training_samples.py:34-40
via PIL. Here there is no reason to leave the device: these jitted
resizes run fused with the rest of the pipeline, enabling

* `cnn --scale 2 ...`: raw image → on-device upscale → SR network in one
  program (the BASELINE "2x-upscaled 1080p" workflow without a separate
  preprocessing step), and
* on-device sample degradation for training-data generation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_METHODS = {"bicubic": "cubic", "cubic": "cubic", "lanczos": "lanczos3",
            "linear": "linear", "nearest": "nearest"}


def resize_plane(img: jnp.ndarray, out_h: int, out_w: int,
                 method: str = "bicubic") -> jnp.ndarray:
    """Resize a (H, W) or (H, W, C) float image."""
    shape = (out_h, out_w) + tuple(img.shape[2:])
    return jax.image.resize(img, shape, method=_METHODS[method])


def upscale_rgba(rgba: jnp.ndarray, factor: float,
                 method: str = "bicubic") -> jnp.ndarray:
    """Upscale a uint8 RGBA/RGB image by ``factor``; returns uint8 with
    the same channel count."""
    h, w = rgba.shape[0], rgba.shape[1]
    out_h, out_w = int(round(h * factor)), int(round(w * factor))
    x = rgba.astype(jnp.float32)
    y = resize_plane(x, out_h, out_w, method)
    return jnp.clip(jnp.round(y), 0, 255).astype(jnp.uint8)


def degrade(img: jnp.ndarray, factor: float, method: str = "bicubic") -> jnp.ndarray:
    """The training degradation model: downscale by ``factor`` then scale
    back to the original size (generate_training_samples.py:34-40),
    entirely on device. ``img``: float (H, W[, C])."""
    h, w = img.shape[0], img.shape[1]
    small_h, small_w = max(1, int(h / factor)), max(1, int(w / factor))
    small = resize_plane(img, small_h, small_w, method)
    return resize_plane(small, h, w, method)
