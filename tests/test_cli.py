"""End-to-end CLI tests — forward and training through the real entry
point (the reference's golden-image + smoke coverage, SURVEY.md §4),
run in-process against `cnn_sr.cli.main`."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from cnn_sr.cli import main

CFG = {
    "n1": 4, "n2": 2, "f1": 3, "f2": 1, "f3": 3,
    "momentum": 0.9, "weight_decay_parameter": 0.0001,
    "learning_rates": [0.01, 0.01, 0.001],
    "parameters_distribution_1": {
        "mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.05, "std_deviation_b": 0.0},
    "parameters_distribution_2": {
        "mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.05, "std_deviation_b": 0.0},
    "parameters_distribution_3": {
        "mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.05, "std_deviation_b": 0.0},
}


@pytest.fixture
def cfg_path(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(CFG))
    return str(p)


@pytest.fixture
def image_path(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (24, 28, 3), dtype=np.uint8)
    p = tmp_path / "in.png"
    Image.fromarray(img, "RGB").save(str(p))
    return str(p)


def _make_samples(tmp_path, n=5, size=14):
    d = tmp_path / "samples"
    os.makedirs(str(d), exist_ok=True)
    rng = np.random.default_rng(1)
    for i in range(n):
        large = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        small = ((large.astype(np.float32) + np.roll(large, 1, 0)) / 2).astype(np.uint8)
        Image.fromarray(large, "RGB").save(str(d / f"s{i}_large.png"))
        Image.fromarray(small, "RGB").save(str(d / f"s{i}_small.png"))
    return str(d)


def test_forward_mode_writes_image(cfg_path, image_path, tmp_path, capsys):
    out = str(tmp_path / "out.png")
    rc = main(["-c", cfg_path, "-i", image_path, "-o", out, "--seed", "0"])
    assert rc == 0
    assert os.path.exists(out)
    result = np.asarray(Image.open(out))
    assert result.shape == (24, 28, 3)
    # border passthrough: corners equal the input image
    orig = np.asarray(Image.open(image_path))
    np.testing.assert_array_equal(result[0, 0], orig[0, 0])
    assert "DONE" in capsys.readouterr().out


def test_forward_dry_mode_writes_nothing(cfg_path, image_path, tmp_path):
    rc = main(["dry", "-c", cfg_path, "-i", image_path, "--seed", "0"])
    assert rc == 0
    assert not list(tmp_path.glob("*.png")) == []  # only the input image exists


def test_out_required_unless_dry(cfg_path, image_path, capsys):
    rc = main(["-c", cfg_path, "-i", image_path])
    assert rc == 1
    assert "dry run" in capsys.readouterr().out


def test_train_mode_end_to_end(cfg_path, tmp_path, capsys):
    samples = _make_samples(tmp_path)
    out = str(tmp_path / "params_out.json")
    rc = main(
        ["train", "-c", cfg_path, "-i", samples, "-o", out, "-e", "3", "--seed", "0"]
    )
    assert rc == 0
    data = json.loads(open(out).read())
    assert data["epochs"] == 3
    assert set(data) == {"epochs", "layer1", "layer2", "layer3"}
    assert len(data["layer1"]["weights"]) == 3 * 3 * 1 * 4
    out_text = capsys.readouterr().out
    assert "mean validation error" in out_text


def test_train_dry_profile(cfg_path, tmp_path, capsys):
    samples = _make_samples(tmp_path)
    rc = main(["train", "dry", "profile", "-c", cfg_path, "-i", samples, "-e", "2"])
    assert rc == 0
    out_text = capsys.readouterr().out
    assert "PROFILING MODE" in out_text
    assert "stage profile" in out_text
    # ranked per-op device-time table (reference profile.py:9-18 analog):
    # the conv layers must dominate and shares must be parseable
    assert "op profile (device time)" in out_text
    assert "conv_general_dilated" in out_text
    assert not os.path.exists(str(tmp_path / "params_out.json"))


def test_forward_then_reload_params_roundtrip(cfg_path, tmp_path, image_path):
    """Train → save params → forward with the trained params via
    config.parameters_file (the reference's resume path)."""
    samples = _make_samples(tmp_path)
    params_out = str(tmp_path / "trained.json")
    assert main(["train", "-c", cfg_path, "-i", samples, "-o", params_out,
                 "-e", "2", "--seed", "0"]) == 0

    cfg2 = dict(CFG)
    cfg2["parameters_file"] = params_out
    cfg2_path = str(tmp_path / "cfg2.json")
    with open(cfg2_path, "w") as fh:
        json.dump(cfg2, fh)
    out_img = str(tmp_path / "up.png")
    assert main(["-c", cfg2_path, "-i", image_path, "-o", out_img]) == 0
    assert os.path.exists(out_img)


def test_forward_spatial_shard_matches_single(cfg_path, image_path, tmp_path):
    """--spatial-shard N: rows split over the virtual mesh with one halo
    exchange; output must be pixel-identical to the single-device run
    (24 rows over 4 devices; also exercises the bottom-pad path via 3
    shards, 24 % 3 == 0 -> and 5 shards with padding)."""
    ref = str(tmp_path / "ref.png")
    assert main(["-c", cfg_path, "-i", image_path, "-o", ref,
                 "--seed", "0"]) == 0
    for n in ("4", "5"):  # 24 % 5 != 0 -> bottom-pad path
        out = str(tmp_path / f"out_s{n}.png")
        assert main(["-c", cfg_path, "-i", image_path, "-o", out,
                     "--seed", "0", "--spatial-shard", n]) == 0
        a = np.asarray(Image.open(out)).astype(int)
        b = np.asarray(Image.open(ref)).astype(int)
        assert np.abs(a - b).max() <= 1, f"spatial-shard {n} diverged"


def test_train_data_parallel_matches_single(cfg_path, tmp_path, capsys):
    """--data-parallel N: the sharded epoch must produce the same
    parameters as the single-device run (10 samples -> train 8 / val 2,
    both divisible by 2)."""
    samples = _make_samples(tmp_path, n=10)
    p1 = str(tmp_path / "p1.json")
    p2 = str(tmp_path / "p2.json")
    assert main(["train", "-c", cfg_path, "-i", samples, "-o", p1,
                 "-e", "3", "--seed", "7"]) == 0
    assert main(["train", "-c", cfg_path, "-i", samples, "-o", p2,
                 "-e", "3", "--seed", "7", "--data-parallel", "2"]) == 0
    w1 = json.load(open(p1))
    w2 = json.load(open(p2))
    for layer in ("layer1", "layer2", "layer3"):
        np.testing.assert_allclose(w1[layer]["weights"],
                                   w2[layer]["weights"], rtol=1e-5, atol=1e-7)


def test_train_data_parallel_indivisible_split_errors(cfg_path, tmp_path):
    samples = _make_samples(tmp_path, n=5)  # train 4 / val 1: 1 % 2 != 0
    with pytest.raises(SystemExit):
        main(["train", "-c", cfg_path, "-i", samples, "-o",
              str(tmp_path / "p.json"), "-e", "1", "--data-parallel", "2"])


def test_cli_packed_io_flag(tmp_path):
    # --packed-io output must be identical to the default path
    import numpy as np
    from PIL import Image

    from cnn_sr.cli import main

    cfg_path = tmp_path / "cfg.json"
    with open(cfg_path, "w") as fh:
        json.dump(CFG, fh)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (24, 30, 3), dtype=np.uint8)
    Image.fromarray(img).save(str(tmp_path / "in.png"))

    outs = {}
    for flag in ("--packed-io", "--no-packed-io"):
        out = tmp_path / f"out{flag}.png"
        rc = main(["-c", str(cfg_path), "-i", str(tmp_path / "in.png"),
                   "-o", str(out), "--seed", "3", flag])
        assert rc == 0
        with Image.open(str(out)) as im:
            outs[flag] = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(outs["--packed-io"], outs["--no-packed-io"])
