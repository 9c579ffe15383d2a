"""On-device resize ops: upscale + degradation model parity with the
out-of-process PIL pipeline (generate_training_samples.py:34-40)."""

import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp

from cnn_sr.ops.resize import degrade, resize_plane, upscale_rgba


def test_upscale_shapes_and_range():
    rng = np.random.default_rng(0)
    rgba = jnp.asarray(rng.integers(0, 256, (20, 30, 4), dtype=np.uint8))
    up = np.asarray(upscale_rgba(rgba, 2.0))
    assert up.shape == (40, 60, 4)
    assert up.dtype == np.uint8


def test_upscale_close_to_pil_bicubic():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    up = np.asarray(upscale_rgba(jnp.asarray(img), 2.0, method="bicubic"))
    pil = np.asarray(
        Image.fromarray(img, "RGB").resize((64, 48), Image.BICUBIC)
    )
    # different bicubic boundary conventions: compare away from edges
    d = up[4:-4, 4:-4].astype(np.int32) - pil[4:-4, 4:-4].astype(np.int32)
    assert np.abs(d).mean() < 6.0, f"mean abs delta {np.abs(d).mean()}"


def test_degrade_removes_high_frequencies():
    rng = np.random.default_rng(2)
    img = jnp.asarray(rng.uniform(0, 1, (32, 32)).astype(np.float32))
    soft = np.asarray(degrade(img, 2.0))
    assert soft.shape == (32, 32)
    hf = lambda a: np.abs(np.diff(a, axis=0)).mean()
    assert hf(soft) < hf(np.asarray(img))


def test_degrade_identity_factor():
    img = jnp.asarray(np.random.default_rng(3).uniform(0, 1, (16, 16)).astype(np.float32))
    out = np.asarray(degrade(img, 1.0))
    np.testing.assert_allclose(out, np.asarray(img), atol=1e-5)


def test_resize_plane_channels():
    img = jnp.asarray(np.random.default_rng(4).uniform(0, 1, (10, 12, 3)).astype(np.float32))
    out = resize_plane(img, 20, 24)
    assert out.shape == (20, 24, 3)
