"""The extended waifu2x-style deeper full-RGB variant (BASELINE.json
config 5): layer-list-generic model, RGB sample loading, CLI train +
forward end-to-end, plus the big-shape smoke test (the reference's
BackpropagationTest big-data dataset, BackpropagationTest.cpp:155-168)."""

import json
import os

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from cnn_sr.cli import main
from cnn_sr.utils.config import read_config

RGB_CFG = {
    "channels": 3,
    "layers": [
        {"n": 8, "f": 3},
        {"n": 6, "f": 3},
        {"n": 6, "f": 3},
        {"n": 3, "f": 3},
    ],
    "momentum": 0.9,
    "weight_decay_parameter": 0.0,
    "learning_rates": [0.003, 0.003, 0.003, 0.0003],
    "parameters_distribution": {
        "mean_w": 0.0, "mean_b": 0.0,
        "std_deviation_w": 0.05, "std_deviation_b": 0.0,
    },
}


@pytest.fixture
def rgb_cfg_path(tmp_path):
    p = tmp_path / "rgb.json"
    p.write_text(json.dumps(RGB_CFG))
    return str(p)


def _make_samples(tmp_path, n=5, size=18):
    d = tmp_path / "samples"
    os.makedirs(str(d), exist_ok=True)
    rng = np.random.default_rng(7)
    for i in range(n):
        large = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        small = ((large.astype(np.float32) + np.roll(large, 1, 1)) / 2).astype(np.uint8)
        Image.fromarray(large, "RGB").save(str(d / f"s{i}_large.png"))
        Image.fromarray(small, "RGB").save(str(d / f"s{i}_small.png"))
    return str(d)


def test_rgb_config_shipped_example():
    cfg = read_config(
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "configs", "waifu2x_7layer_rgb.json")
    )
    assert cfg.num_layers == 7 and cfg.channels == 3
    specs = cfg.layer_specs()
    assert specs[0].n_in == 3 and specs[-1].n_out == 3


def test_rgb_train_and_forward_cli(rgb_cfg_path, tmp_path):
    samples = _make_samples(tmp_path)
    params_out = str(tmp_path / "rgb_params.json")
    rc = main(["train", "-c", rgb_cfg_path, "-i", samples, "-o", params_out,
               "-e", "3", "--seed", "0"])
    assert rc == 0
    data = json.loads(open(params_out).read())
    assert set(data) == {"epochs", "layer1", "layer2", "layer3", "layer4"}
    assert len(data["layer4"]["weights"]) == 3 * 3 * 6 * 3

    cfg2 = dict(RGB_CFG)
    cfg2["parameters_file"] = params_out
    cfg2_path = str(tmp_path / "rgb2.json")
    with open(cfg2_path, "w") as fh:
        json.dump(cfg2, fh)

    rng = np.random.default_rng(1)
    img_path = str(tmp_path / "photo.png")
    Image.fromarray(rng.integers(0, 256, (30, 34, 3), dtype=np.uint8), "RGB").save(img_path)
    out_path = str(tmp_path / "up.png")
    rc = main(["-c", cfg2_path, "-i", img_path, "-o", out_path])
    assert rc == 0
    out = np.asarray(Image.open(out_path))
    assert out.shape == (30, 34, 3)
    # border passthrough (total shrink = 8, pad = 4)
    orig = np.asarray(Image.open(img_path))
    np.testing.assert_array_equal(out[0, 0], orig[0, 0])
    # center replaced
    assert not np.array_equal(out[15, 17], orig[15, 17])


def test_rgb_training_learns(rgb_cfg_path, tmp_path):
    from cnn_sr.training.samples import find_training_samples, load_sample_set
    from cnn_sr.training.trainer import init_train_state, train_loop

    samples_dir = _make_samples(tmp_path, n=6, size=16)
    cfg = read_config(rgb_cfg_path)
    samples = load_sample_set(find_training_samples(samples_dir), channels=3)
    assert samples.input_luma.shape[-1] == 3
    state = init_train_state(cfg, seed=0)
    errs = []
    error = train_loop(
        cfg, samples, state, epochs=20, validation_cadence=1, seed=0,
        log=lambda *a: None,
        on_epoch=lambda e, v: errs.append(v) if v is not None else None,
    )
    assert not error
    assert errs[-1] < errs[0], f"RGB training not learning: {errs[0]} -> {errs[-1]}"


@pytest.mark.slow
def test_big_shape_smoke():
    """1024x1024, 32->16 filters: 'didn't crash? then ok'
    (BackpropagationTest.cpp:155-168)."""
    from cnn_sr.models import loss_sum

    rng = np.random.default_rng(0)
    params = [
        {"w": jnp.asarray(rng.standard_normal((3, 3, 1, 32)).astype(np.float32) * 0.05),
         "b": jnp.zeros(32)},
        {"w": jnp.asarray(rng.standard_normal((3, 3, 32, 16)).astype(np.float32) * 0.05),
         "b": jnp.zeros(16)},
        {"w": jnp.asarray(rng.standard_normal((3, 3, 16, 1)).astype(np.float32) * 0.05),
         "b": jnp.zeros(1)},
    ]
    x = jnp.asarray(rng.standard_normal((1, 1024, 1024, 1)).astype(np.float32))
    gt = jnp.asarray(rng.uniform(0, 1, (1, 1024, 1024, 1)).astype(np.float32))
    grads = jax.jit(jax.grad(loss_sum))(params, x, gt)
    jax.block_until_ready(grads)
    for g in grads:
        assert np.isfinite(np.asarray(g["w"])).all()
