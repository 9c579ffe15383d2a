"""The ``zero_mean_target`` config extension: the net learns
mean-relative luma and inference adds the input mean back — removing
the Var(per-image mean) error floor of the reference's input-only mean
subtraction (Main_cl.cpp:141; targets stay absolute there).
"""

import numpy as np
from PIL import Image

from cnn_sr.api import upscale_image
from cnn_sr.training.samples import load_sample_set
from cnn_sr.training.trainer import init_train_state
from cnn_sr.utils.config import parse_config

CFG = {
    "n1": 4, "n2": 2, "f1": 3, "f2": 1, "f3": 3,
    "momentum": 0.9, "weight_decay_parameter": 0.0,
    "learning_rates": [0.01, 0.01, 0.001],
    **{
        f"parameters_distribution_{i}": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.0,
        }
        for i in (1, 2, 3)
    },
}


def test_config_flag_parses_and_defaults_off():
    assert parse_config(CFG).zero_mean_target is False
    assert parse_config(dict(CFG, zero_mean_target=True)).zero_mean_target


def test_relu_gate_defaults():
    # parity default: gate on; zero_mean_target flips it off (signed
    # targets would freeze); explicit key always wins
    assert parse_config(CFG).last_layer_relu_gate is True
    assert parse_config(dict(CFG, zero_mean_target=True)
                        ).last_layer_relu_gate is False
    assert parse_config(dict(CFG, zero_mean_target=True,
                             last_layer_relu_gate=True)
                        ).last_layer_relu_gate is True


def test_relu_gate_off_gives_plain_mse_gradients():
    import jax
    import jax.numpy as jnp

    from cnn_sr.models import forward, loss_sum
    from cnn_sr.models.srcnn import center_crop

    cfg = parse_config(CFG)
    params = init_train_state(cfg, seed=3).params
    params = [{"w": jnp.asarray(l["w"]), "b": jnp.asarray(l["b"])}
              for l in params]
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((2, 12, 12, 1)).astype(np.float32))
    # signed targets: some outputs must go negative
    t = jnp.asarray(rng.standard_normal((2, 12, 12, 1)).astype(np.float32))

    def plain_mse(p, x, t):
        y = forward(p, x)
        d = y - center_crop(t, y.shape[-3], y.shape[-2])
        return 0.5 * jnp.sum(d * d)

    g_off = jax.grad(lambda p: loss_sum(p, x, t, relu_gate=False))(params)
    g_ref = jax.grad(lambda p: plain_mse(p, x, t))(params)
    for a, b in zip(g_off, g_ref):
        np.testing.assert_allclose(a["w"], b["w"], rtol=1e-6, atol=1e-7)

    g_on = jax.grad(lambda p: loss_sum(p, x, t, relu_gate=True))(params)
    assert any(
        np.abs(np.asarray(a["w"]) - np.asarray(b["w"])).max() > 1e-8
        for a, b in zip(g_on, g_off)
    )


def test_sample_targets_become_mean_relative(tmp_path):
    rng = np.random.default_rng(0)
    pairs = []
    for i in range(2):
        large = rng.integers(0, 256, (12, 12, 3), dtype=np.uint8)
        small = rng.integers(0, 256, (12, 12, 3), dtype=np.uint8)
        lp, sp = str(tmp_path / f"s{i}_large.png"), str(tmp_path / f"s{i}_small.png")
        Image.fromarray(large, "RGB").save(lp)
        Image.fromarray(small, "RGB").save(sp)
        pairs.append((lp, sp))

    ref = load_sample_set(pairs, channels=1)
    zm = load_sample_set(pairs, channels=1, zero_mean_target=True)
    np.testing.assert_allclose(zm.input_luma, ref.input_luma, atol=1e-6)
    for i in range(2):
        # recover the input mean from the reference-mode arrays: the raw
        # small luma mean equals (raw - zero-mean) at any pixel... use
        # the target delta directly: exp_zm = exp_ref - mean(small)
        delta = ref.expected_luma[i] - zm.expected_luma[i]
        assert np.allclose(delta, delta.flat[0], atol=1e-6)  # constant shift
        assert 0.0 < delta.flat[0] < 1.0


def test_inference_is_mean_equivariant_with_flag():
    """Shifting the whole input by +c shifts the output luma by +c when
    zero_mean_target is on (the zero-mean net input is unchanged), and
    does NOT without the flag."""
    rng = np.random.default_rng(1)
    cfg_ref = parse_config(CFG)
    cfg_zm = parse_config(dict(CFG, zero_mean_target=True))
    params = init_train_state(cfg_ref, seed=0).params

    base = rng.integers(60, 180, (20, 24, 3), dtype=np.uint8)
    img1 = np.dstack([base, np.full(base.shape[:2], 255, np.uint8)])
    img2 = np.dstack([base + 40, np.full(base.shape[:2], 255, np.uint8)])

    def center_luma(out):
        y = (0.299 * out[..., 0] + 0.587 * out[..., 1]
             + 0.114 * out[..., 2]).astype(np.float64)
        pad = cfg_ref.total_padding() // 2
        return y[pad:-pad, pad:-pad]

    o1 = upscale_image(cfg_zm, params, img1)
    o2 = upscale_image(cfg_zm, params, img2)
    d = center_luma(o2) - center_luma(o1)
    # +40 RGB shift = +40 luma shift (Rec.601 weights sum to 1), within
    # uint8 truncation noise
    assert abs(np.median(d) - 40.0) < 2.0

    r1 = upscale_image(cfg_ref, params, img1)
    r2 = upscale_image(cfg_ref, params, img2)
    dr = center_luma(r2) - center_luma(r1)
    # without the flag the net output ignores the mean shift entirely
    # (both zero-mean inputs are identical), modulo output clamping
    assert abs(np.median(dr)) < 2.0


def test_bucketed_path_matches_exact_with_flag():
    rng = np.random.default_rng(2)
    cfg = parse_config(dict(CFG, zero_mean_target=True))
    params = init_train_state(cfg, seed=0).params
    img = np.dstack([
        rng.integers(0, 256, (20, 24, 3), dtype=np.uint8),
        np.full((20, 24), 255, np.uint8),
    ])
    exact = upscale_image(cfg, params, img, bucket=0)
    bucketed = upscale_image(cfg, params, img, bucket=16)
    np.testing.assert_array_equal(exact, bucketed)


def test_direct_config_construction_couples_gate():
    # the zero_mean_target -> gate-off default must hold for direct
    # Config(...) construction too, not just parse_config
    from cnn_sr.utils.config import Config

    base = parse_config(CFG)
    c = Config(
        filter_counts=base.filter_counts, spatial_sizes=base.spatial_sizes,
        momentum=base.momentum, weight_decay=base.weight_decay,
        learning_rates=base.learning_rates, distributions=base.distributions,
        zero_mean_target=True,
    )
    assert c.last_layer_relu_gate is False
    c2 = Config(
        filter_counts=base.filter_counts, spatial_sizes=base.spatial_sizes,
        momentum=base.momentum, weight_decay=base.weight_decay,
        learning_rates=base.learning_rates, distributions=base.distributions,
        zero_mean_target=True, last_layer_relu_gate=True,
    )
    assert c2.last_layer_relu_gate is True
