"""The committed pretrained checkpoint must stay loadable and useful.

Guards the `pretrained/` artifact (trained in-repo on `--synthetic`
data — see pretrained/README.md): reference-format JSON loads through
the normal codec, shapes match the flagship config, and the network
actually beats bicubic PSNR(Y) on a held-out synthetic image — a drift
test for the whole load→forward→swap-luma chain, not just the file."""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

CKPT = os.path.join(REPO, "pretrained", "srcnn_9-5-5_synthetic.json")
CFG = os.path.join(REPO, "configs", "srcnn_9-5-5_pretrained.json")
PHOTO_CKPT = os.path.join(REPO, "pretrained", "srcnn_9-5-5_photo.json")
PHOTO_CFG = os.path.join(REPO, "configs",
                         "srcnn_9-5-5_photo_pretrained.json")
RGB_CKPT = os.path.join(REPO, "pretrained", "waifu2x_7layer_rgb_synthetic.json")
RGB_CFG = os.path.join(REPO, "configs", "waifu2x_7layer_rgb_pretrained.json")


def test_pretrained_checkpoint_loads():
    from cnn_sr.utils.config import read_config
    from cnn_sr.utils.params_io import load_parameters_file

    cfg = read_config(CFG)
    assert cfg.zero_mean_target and not cfg.last_layer_relu_gate
    assert os.path.samefile(cfg.parameters_file, CKPT)
    params, epochs = load_parameters_file(CKPT, cfg.layer_specs())
    assert epochs == 32000  # 5-phase round-4 recipe (12k+8k+4k+4k+4k)
    shapes = [p["w"].shape for p in params]
    assert shapes == [(9, 9, 1, 64), (5, 5, 64, 32), (5, 5, 32, 1)]
    for p in params:
        assert np.isfinite(p["w"]).all() and np.isfinite(p["b"]).all()


def test_photo_checkpoint_loads():
    """The round-5 photo-adapted flagship checkpoint (synthetic phases
    + one compare.jpg-crop adaptation leg — pretrained/README.md's
    held-out protocol): loads through the codec, shapes match, and it
    still beats bicubic on a held-out synthetic draw (the adaptation
    must not have destroyed the synthetic family)."""
    from generate_training_samples import _degrade_pil, synth_image

    from cnn_sr.api import upscale_image
    from cnn_sr.utils.config import read_config
    from cnn_sr.utils.metrics import psnr_y
    from cnn_sr.utils.params_io import load_parameters_file

    cfg = read_config(PHOTO_CFG)
    assert cfg.zero_mean_target and not cfg.last_layer_relu_gate
    assert os.path.samefile(cfg.parameters_file, PHOTO_CKPT)
    params, epochs = load_parameters_file(PHOTO_CKPT, cfg.layer_specs())
    assert epochs == 34000  # 32k synthetic phases + the 2k photo leg
    assert [p["w"].shape for p in params] == [
        (9, 9, 1, 64), (5, 5, 64, 32), (5, 5, 32, 1)]

    rng = np.random.default_rng(123456)
    gt = synth_image(rng, 128)
    degraded = _degrade_pil(gt, 128, 3)
    gt_rgb, deg_rgb = np.asarray(gt), np.asarray(degraded)
    rgba = np.dstack([deg_rgb, np.full(deg_rgb.shape[:2], 255, np.uint8)])
    out = upscale_image(cfg, params, rgba)
    assert psnr_y(gt_rgb, out) > psnr_y(gt_rgb, deg_rgb)


def test_pretrained_checkpoint_beats_bicubic():
    from generate_training_samples import _degrade_pil, synth_image

    from cnn_sr.api import upscale_image
    from cnn_sr.utils.config import read_config
    from cnn_sr.utils.metrics import psnr_y
    from cnn_sr.utils.params_io import load_parameters_file

    cfg = read_config(CFG)
    params, _ = load_parameters_file(CKPT, cfg.layer_specs())

    # held-out draw (seed differs from the training/eval/demo sets)
    rng = np.random.default_rng(123456)
    gt = synth_image(rng, 128)
    degraded = _degrade_pil(gt, 128, 3)
    gt_rgb = np.asarray(gt)
    deg_rgb = np.asarray(degraded)
    rgba = np.dstack(
        [deg_rgb, np.full(deg_rgb.shape[:2], 255, np.uint8)]
    )

    out = upscale_image(cfg, params, rgba)
    base = psnr_y(gt_rgb, deg_rgb)
    net = psnr_y(gt_rgb, out)
    assert net > base + 0.1, (base, net)


def test_rgb_pretrained_checkpoint_loads():
    from cnn_sr.utils.config import read_config
    from cnn_sr.utils.params_io import load_parameters_file

    cfg = read_config(RGB_CFG)
    assert cfg.channels == 3 and cfg.zero_mean_target
    assert not cfg.last_layer_relu_gate
    params, epochs = load_parameters_file(RGB_CKPT, cfg.layer_specs())
    assert epochs == 27000
    assert [p["w"].shape for p in params] == [
        (3, 3, 3, 32), (3, 3, 32, 32), (3, 3, 32, 64), (3, 3, 64, 64),
        (3, 3, 64, 128), (3, 3, 128, 128), (3, 3, 128, 3),
    ]
    for p in params:
        assert np.isfinite(p["w"]).all() and np.isfinite(p["b"]).all()


def test_rgb_pretrained_checkpoint_beats_bicubic():
    """Held-out drift test for the 7-layer RGB checkpoint (trained at
    +1.27 dB mean over bicubic on 12 held-out 192² images — see
    pretrained/README.md)."""
    from generate_training_samples import _degrade_pil, synth_image

    from cnn_sr.api import upscale_image
    from cnn_sr.utils.config import read_config
    from cnn_sr.utils.metrics import psnr_y
    from cnn_sr.utils.params_io import load_parameters_file

    cfg = read_config(RGB_CFG)
    params, _ = load_parameters_file(RGB_CKPT, cfg.layer_specs())

    rng = np.random.default_rng(987654)  # unseen draw
    gt = synth_image(rng, 128)
    degraded = _degrade_pil(gt, 128, 3)
    gt_rgb = np.asarray(gt)
    deg_rgb = np.asarray(degraded)
    rgba = np.dstack([deg_rgb, np.full(deg_rgb.shape[:2], 255, np.uint8)])

    out = upscale_image(cfg, params, rgba)
    base = psnr_y(gt_rgb, deg_rgb)
    net = psnr_y(gt_rgb, out)
    assert net > base + 0.1, (base, net)
