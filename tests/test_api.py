"""API-level tests: single vs batched upscaling, fast_forward parity."""

import numpy as np
import pytest

import jax.numpy as jnp

from cnn_sr.api import upscale_batch, upscale_image
from cnn_sr.models import forward
from cnn_sr.models.fast_forward import fast_forward
from cnn_sr.utils.config import parse_config
from cnn_sr.utils.params_io import random_parameters

CFG = {
    "n1": 4, "n2": 2, "f1": 3, "f2": 1, "f3": 3,
    "momentum": 0.9, "weight_decay_parameter": 0.0,
    "learning_rates": [1e-3, 1e-3, 1e-4],
    **{
        f"parameters_distribution_{i}": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.0,
        }
        for i in (1, 2, 3)
    },
}


def test_upscale_batch_matches_single():
    cfg = parse_config(CFG)
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=0)
    rng = np.random.default_rng(1)
    rgbas = rng.integers(0, 256, (3, 20, 24, 4), dtype=np.uint8)
    batched = upscale_batch(cfg, params, rgbas)
    assert batched.shape == (3, 20, 24, 3)
    for i in range(3):
        single = upscale_image(cfg, params, rgbas[i])
        np.testing.assert_array_equal(batched[i], single)


@pytest.mark.parametrize("k_in", [1, 3])
def test_fast_forward_f32_matches_conv(k_in):
    rng = np.random.default_rng(2)
    params = [
        {"w": jnp.asarray(rng.standard_normal((5, 5, k_in, 8)).astype(np.float32) * 0.1),
         "b": jnp.asarray(rng.standard_normal(8).astype(np.float32) * 0.1)},
        {"w": jnp.asarray(rng.standard_normal((3, 3, 8, 4)).astype(np.float32) * 0.1),
         "b": jnp.asarray(rng.standard_normal(4).astype(np.float32) * 0.1)},
        {"w": jnp.asarray(rng.standard_normal((3, 3, 4, k_in)).astype(np.float32) * 0.1),
         "b": jnp.asarray(rng.standard_normal(k_in).astype(np.float32) * 0.1)},
    ]
    x = jnp.asarray(rng.standard_normal((2, 24, 28, k_in)).astype(np.float32))
    y_conv = forward(params, x)
    y_fast = fast_forward(params, x, dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(y_fast), np.asarray(y_conv), rtol=1e-4, atol=1e-5
    )


def test_fast_forward_bf16_close():
    rng = np.random.default_rng(3)
    params = [
        {"w": jnp.asarray(rng.standard_normal((9, 9, 1, 8)).astype(np.float32) * 0.05),
         "b": jnp.zeros(8)},
        {"w": jnp.asarray(rng.standard_normal((5, 5, 8, 1)).astype(np.float32) * 0.05),
         "b": jnp.zeros(1)},
    ]
    x = jnp.asarray(rng.uniform(-1, 1, (1, 40, 40, 1)).astype(np.float32))
    y_conv = np.asarray(forward(params, x))
    y_fast = np.asarray(fast_forward(params, x, dtype=jnp.bfloat16))
    assert np.abs(y_fast - y_conv).max() < 0.02


def test_bucketed_upscale_identical_to_exact():
    """Shape bucketing must not change a single output byte."""
    cfg = parse_config(CFG)
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=4)
    rng = np.random.default_rng(5)
    for h, w in [(30, 37), (64, 64), (41, 70)]:
        rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        exact = upscale_image(cfg, params, rgba)
        bucketed = upscale_image(cfg, params, rgba, bucket=64)
        np.testing.assert_array_equal(bucketed, exact, err_msg=f"shape {h}x{w}")


def test_bucketed_upscale_squared_mean_quirk():
    """The binary-compat quirk (subtract_squared_mean) through the
    BUCKETED path: its masked-mean variant must square under the mask
    and still match the exact program byte-for-byte."""
    cfg = parse_config({**CFG, "subtract_squared_mean": True})
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=4)
    rng = np.random.default_rng(6)
    for h, w in [(30, 37), (41, 70)]:
        rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        exact = upscale_image(cfg, params, rgba)
        bucketed = upscale_image(cfg, params, rgba, bucket=64)
        np.testing.assert_array_equal(bucketed, exact, err_msg=f"{h}x{w}")
        # and it must differ from the non-quirk output (flag is live)
        plain = upscale_image(parse_config(CFG), params, rgba)
        assert np.any(plain != exact)


def test_rgb_bucketed_upscale_identical():
    raw = {
        "channels": 3,
        "layers": [{"n": 6, "f": 3}, {"n": 4, "f": 3}, {"n": 3, "f": 3}],
        "momentum": 0.9, "weight_decay_parameter": 0.0,
        "learning_rates": [1e-3] * 3,
        "parameters_distribution": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.0,
        },
    }
    cfg = parse_config(raw)
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=6)
    rng = np.random.default_rng(7)
    for h, w in [(25, 31), (40, 40)]:
        rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        exact = upscale_image(cfg, params, rgba)
        bucketed = upscale_image(cfg, params, rgba, bucket=32)
        np.testing.assert_array_equal(bucketed, exact, err_msg=f"shape {h}x{w}")


def test_upscale_rejects_tiny_images():
    """Images not larger than the receptive field get a clean ValueError
    (previously an opaque XLA negative-slice crash deep in swap-luma)."""
    cfg = parse_config({**CFG, "n1": 8, "n2": 8, "f1": 9, "f2": 5, "f3": 5})
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=2)
    tiny = np.zeros((16, 30, 4), np.uint8)  # shrink = 16
    with pytest.raises(ValueError, match="receptive field"):
        upscale_image(cfg, params, tiny, bucket=64)
    with pytest.raises(ValueError, match="receptive field"):
        upscale_batch(cfg, params, tiny[None])


def test_upscale_packed_io_bit_identical():
    # the uint32 byte-packed color-end path must reproduce the rank-3
    # path exactly (shared expression core in ops.color), including a
    # zero_mean_target config (mean added back before the swap)
    for zmt in (False, True):
        cfg = parse_config({**CFG, "zero_mean_target": zmt})
        params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=2)
        rng = np.random.default_rng(7)
        rgba = rng.integers(0, 256, (21, 26, 4), dtype=np.uint8)
        ref = upscale_image(cfg, params, rgba)
        got = upscale_image(cfg, params, rgba, packed_io=True)
        np.testing.assert_array_equal(got, ref)
        assert got.flags["C_CONTIGUOUS"]


def test_upscale_batch_packed_io_bit_identical():
    cfg = parse_config(CFG)
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=3)
    rng = np.random.default_rng(8)
    rgbas = rng.integers(0, 256, (2, 20, 24, 4), dtype=np.uint8)
    ref = upscale_batch(cfg, params, rgbas)
    got = upscale_batch(cfg, params, rgbas, packed_io=True)
    np.testing.assert_array_equal(got, ref)


def test_upscale_rgb_packed_io_bit_identical():
    cfg = parse_config({
        "channels": 3,
        "layers": [{"n": 4, "f": 3}, {"n": 4, "f": 1}, {"n": 3, "f": 3}],
        "momentum": 0.9, "weight_decay_parameter": 0.0,
        "learning_rates": [1e-3, 1e-3, 1e-4],
        "parameters_distribution": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.0,
        },
    })
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=4)
    rng = np.random.default_rng(9)
    rgba = rng.integers(0, 256, (19, 23, 4), dtype=np.uint8)
    ref = upscale_image(cfg, params, rgba)
    got = upscale_image(cfg, params, rgba, packed_io=True)
    np.testing.assert_array_equal(got, ref)


def test_upscale_batch_rgb_packed_io_bit_identical():
    cfg = parse_config({
        "channels": 3,
        "layers": [{"n": 4, "f": 3}, {"n": 3, "f": 3}, {"n": 3, "f": 1}],
        "momentum": 0.9, "weight_decay_parameter": 0.0,
        "learning_rates": [1e-3, 1e-3, 1e-4],
        "parameters_distribution": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.0,
        },
    })
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=5)
    rng = np.random.default_rng(10)
    rgbas = rng.integers(0, 256, (2, 18, 22, 4), dtype=np.uint8)
    ref = upscale_batch(cfg, params, rgbas)
    got = upscale_batch(cfg, params, rgbas, packed_io=True)
    np.testing.assert_array_equal(got, ref)
