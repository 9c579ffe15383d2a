"""Full-state checkpoint/resume: interrupted == uninterrupted training.

The reference's params JSON resets momentum + shuffle RNG on resume
(ConfigBasedDataPipeline.cpp:388-465 stores only weights/bias/epochs);
the ``.state.npz`` sidecar extension removes that gap.
"""

import json
import os
import subprocess
import sys

import numpy as np

from cnn_sr.training.checkpoint import (
    load_full_state, save_full_state, sidecar_path)
from cnn_sr.training.samples import SampleSet
from cnn_sr.training.trainer import init_train_state, train_loop
from cnn_sr.utils.config import parse_config
from cnn_sr.utils.params_io import save_parameters_file

CFG = {
    "n1": 4, "n2": 2, "f1": 3, "f2": 1, "f3": 3,
    "momentum": 0.9, "weight_decay_parameter": 0.0001,
    "learning_rates": [0.01, 0.01, 0.001],
    **{
        f"parameters_distribution_{i}": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.01,
        }
        for i in (1, 2, 3)
    },
}


def _samples(n=6, hw=16, seed=3):
    rng = np.random.default_rng(seed)
    return SampleSet(
        input_luma=rng.random((n, hw, hw, 1), np.float32),
        expected_luma=rng.random((n, hw, hw, 1), np.float32),
        width=hw, height=hw,
    )


def _run(state, samples, cfg, epochs, rng=None, seed=0):
    err = train_loop(cfg, samples, state, epochs,
                     validation_percent=20, seed=seed, rng=rng,
                     log=lambda *_: None)
    assert not err
    return state


def test_split_run_with_sidecar_matches_straight_run(tmp_path):
    cfg = parse_config(CFG)
    samples = _samples()

    # straight: 6 epochs in one go
    straight = _run(init_train_state(cfg, seed=0), samples, cfg, 6)

    # split: 3 epochs, save full state, restore, 3 more
    st = init_train_state(cfg, seed=0)
    rng = np.random.default_rng(0)
    _run(st, samples, cfg, 3, rng=rng)
    params_path = str(tmp_path / "p.json")
    save_parameters_file(params_path, st.params, epochs=st.epochs)
    save_full_state(params_path, st, rng)

    cfg2 = parse_config(dict(CFG, parameters_file=params_path))
    st2 = init_train_state(cfg2)
    assert st2.epochs == 3
    rng2 = load_full_state(params_path, st2)
    assert rng2 is not None
    for a, b in zip(st2.prev_delta, st.prev_delta):
        np.testing.assert_array_equal(a["w"], b["w"])
    _run(st2, samples, cfg2, 3, rng=rng2)

    for a, b in zip(st2.params, straight.params):
        np.testing.assert_allclose(a["w"], b["w"], rtol=0, atol=0)
        np.testing.assert_allclose(a["b"], b["b"], rtol=0, atol=0)

    # WITHOUT the sidecar (reference behavior) the runs must diverge —
    # otherwise this test proves nothing
    st3 = init_train_state(cfg2)
    _run(st3, samples, cfg2, 3, seed=0)
    assert any(
        np.abs(np.asarray(a["w"]) - np.asarray(b["w"])).max() > 0
        for a, b in zip(st3.params, straight.params)
    )


def test_sidecar_rejects_stale_state(tmp_path):
    cfg = parse_config(CFG)
    samples = _samples()
    st = init_train_state(cfg, seed=0)
    rng = np.random.default_rng(0)
    _run(st, samples, cfg, 2, rng=rng)
    params_path = str(tmp_path / "p.json")
    save_parameters_file(params_path, st.params, epochs=st.epochs)
    save_full_state(params_path, st, rng)

    # epoch-counter mismatch (params file replaced) -> sidecar ignored
    save_parameters_file(params_path, st.params, epochs=99)
    cfg2 = parse_config(dict(CFG, parameters_file=params_path))
    st2 = init_train_state(cfg2)
    assert load_full_state(params_path, st2) is None

    # missing sidecar -> None
    os.remove(sidecar_path(params_path))
    assert load_full_state(params_path, st2) is None


def test_cli_full_state_flag(tmp_path):
    # drive the real CLI: train 2 epochs with --full-state, resume 2 more
    from PIL import Image

    cfgd = dict(CFG)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfgd))
    d = tmp_path / "samples"
    os.makedirs(str(d))
    rng = np.random.default_rng(5)
    for i in range(3):
        big = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        small = np.roll(big, 1, 0)
        Image.fromarray(big, "RGB").save(str(d / f"s{i}_large.png"))
        Image.fromarray(small, "RGB").save(str(d / f"s{i}_small.png"))
    out = str(tmp_path / "p.json")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(root, "cnn.py"), "train",
         "-c", str(cfg_path), "-i", str(d), "-e", "2", "-o", out,
         "--full-state", "--seed", "0"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.isfile(out + ".state.npz")

    cfg_path.write_text(json.dumps(dict(cfgd, parameters_file=out)))
    r = subprocess.run(
        [sys.executable, os.path.join(root, "cnn.py"), "train",
         "-c", str(cfg_path), "-i", str(d), "-e", "2",
         "-o", str(tmp_path / "p2.json"), "--full-state"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Resumed full training state" in r.stdout


def test_sidecar_corrupt_file_ignored(tmp_path):
    """A truncated/garbage sidecar (killed mid-write) must fall back to
    fresh momentum/RNG, not crash resume (np.load raises BadZipFile,
    which is not an OSError)."""
    cfg = parse_config(CFG)
    st = init_train_state(cfg, seed=0)
    params_path = str(tmp_path / "p.json")
    save_parameters_file(params_path, st.params, epochs=st.epochs)
    with open(sidecar_path(params_path), "wb") as f:
        f.write(b"PK\x03\x04 definitely not a real zip")
    assert load_full_state(params_path, st) is None
