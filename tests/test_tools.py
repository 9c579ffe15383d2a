"""Tooling-script tests: sample generation, scheduling, weight viz —
the reference's out-of-process Python tooling (SURVEY.md §2.4) driven
in-process."""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

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


def test_generate_training_samples(tmp_path):
    import generate_training_samples as g

    raw = tmp_path / "raw"
    out = tmp_path / "samples"
    os.makedirs(str(raw))
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(
            rng.integers(0, 256, (40, 50, 3), dtype=np.uint8), "RGB"
        ).save(str(raw / f"img{i}.png"))
    # one too-small image that must be skipped with a message
    Image.fromarray(np.zeros((8, 8, 3), np.uint8), "RGB").save(str(raw / "tiny.png"))

    rc = g.main(["-i", str(raw), "-o", str(out), "-s", "24", "-d", "2", "--seed", "0"])
    assert rc == 0
    names = sorted(os.listdir(str(out)))
    larges = [n for n in names if "_large" in n]
    smalls = [n for n in names if "_small" in n]
    assert len(larges) == 3 and len(smalls) == 3
    for n in names:
        with Image.open(str(out / n)) as im:
            assert im.size == (24, 24)
    # degraded image must actually be blurrier (lower high-freq energy)
    with Image.open(str(out / larges[0])) as im:
        l = np.asarray(im.convert("L"), dtype=np.float32)
    with Image.open(str(out / smalls[0])) as im:
        s = np.asarray(im.convert("L"), dtype=np.float32)
    assert np.abs(np.diff(s, axis=0)).mean() < np.abs(np.diff(l, axis=0)).mean()


def test_generate_training_samples_synthetic(tmp_path):
    import generate_training_samples as g

    out = tmp_path / "samples"
    rc = g.main(["--synthetic", "4", "-o", str(out), "-s", "48", "-d", "3",
                 "--seed", "3"])
    assert rc == 0
    names = sorted(os.listdir(str(out)))
    assert len([n for n in names if "_large" in n]) == 4
    # synthetic mode defaults to lossless png (JPEG ringing on edge-dense
    # synthetic content is an unlearnable-noise floor — docs/TRAINING.md)
    assert all(n.endswith(".png") for n in names)
    for n in names:
        with Image.open(str(out / n)) as im:
            assert im.size == (48, 48) and im.mode == "RGB"
    # deterministic given the seed
    out2 = tmp_path / "samples2"
    assert g.main(["--synthetic", "4", "-o", str(out2), "-s", "48", "-d", "3",
                   "--seed", "3", "--format", "png"]) == 0
    with Image.open(str(out / "sample_2_large.png")) as im:
        a = np.asarray(im)
    with Image.open(str(out2 / "sample_2_large.png")) as im:
        b = np.asarray(im)
    np.testing.assert_array_equal(a, b)
    # synthetic content must actually contain edges (not a flat field) —
    # averaged over the set: any single small crop can legitimately land
    # on a smooth region (and does, seed-dependently)
    dens = []
    for n in names:
        if "_large" not in n:
            continue
        with Image.open(str(out / n)) as im:
            arr = np.asarray(im).astype(np.float32)
        dens.append(np.abs(np.diff(arr, axis=0)).mean())
    assert np.mean(dens) > 1.0, dens
    # --in-dir and --synthetic are mutually exclusive / one required
    with pytest.raises(SystemExit):
        g.main(["-o", str(out), "-s", "16"])
    with pytest.raises(SystemExit):
        g.main(["-i", str(tmp_path), "--synthetic", "2", "-o", str(out), "-s", "16"])


def test_generate_training_samples_empty_dir(tmp_path):
    import generate_training_samples as g

    raw = tmp_path / "raw"
    os.makedirs(str(raw))
    rc = g.main(["-i", str(raw), "-o", str(tmp_path / "out"), "-s", "16"])
    assert rc == 1  # "No files were created"


def test_weights_visualize(tmp_path):
    import weights_visualize as wv

    from cnn_sr.utils.config import parse_config
    from cnn_sr.utils.params_io import random_parameters, save_parameters_file

    cfg = parse_config(CFG)
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=0)
    ppath = str(tmp_path / "p.json")
    save_parameters_file(ppath, params, epochs=10)
    cpath = str(tmp_path / "cfg.json")
    with open(cpath, "w") as fh:
        json.dump(CFG, fh)

    out = str(tmp_path / "viz")
    rc = wv.main(["-c", cpath, "-p", ppath, "-o", out, "--scale", "2"])
    assert rc == 0
    for i in (1, 2, 3):
        path = os.path.join(out, f"weights{i}.png")
        assert os.path.exists(path)
    # layer1 sheet: 4 filters x 1 input channel of 3x3 at scale 2
    with Image.open(os.path.join(out, "weights1.png")) as im:
        assert im.size[1] > im.size[0]  # n rows > k cols


def test_schedule_training_convert_and_dry(tmp_path, monkeypatch):
    import schedule_training as st

    assert st.convert_to_seconds("90s") == 90
    assert st.convert_to_seconds("2m") == 120
    assert st.convert_to_seconds("1h") == 3600

    # run 1 iteration against a stub subprocess to check log + snapshot flow
    calls = []

    def fake_call(cmd, stdout=None, stderr=None):
        calls.append(cmd)
        params = {"epochs": 1, **{f"layer{i}": {"weights": [0.0], "bias": [0.0]} for i in (1, 2, 3)}}
        with open(str(tmp_path / "params.json"), "w") as fh:
            json.dump(params, fh)
        return 0

    monkeypatch.setattr(st.subprocess, "call", fake_call)
    rc = st.main([
        "-c", "cfg.json", "-i", "samples", "--epochs", "500",
        "--epochs-per-iteration", "500",
        "--params-file", str(tmp_path / "params.json"),
        "--logs-dir", str(tmp_path / "logs"),
    ])
    assert rc == 0
    assert len(calls) == 1
    logs = os.listdir(str(tmp_path / "logs"))
    assert any(n.startswith("log_") for n in logs)
    assert any(n.startswith("parameters_") for n in logs)

    # trailing args forward verbatim to each cnn.py invocation
    calls.clear()
    rc = st.main([
        "-c", "cfg.json", "-i", "samples", "--epochs", "500",
        "--epochs-per-iteration", "500",
        "--params-file", str(tmp_path / "params.json"),
        "--logs-dir", str(tmp_path / "logs"),
        "--", "--train-precision", "bf16", "--data-parallel", "4",
    ])
    assert rc == 0
    assert calls[0][-4:] == ["--train-precision", "bf16",
                             "--data-parallel", "4"]

