"""Multi-epoch scanned dispatch must be bit-equivalent (up to float
tolerance) to the per-epoch loop: same RNG order, same updates, same
validation values."""

import numpy as np

from cnn_sr.training.samples import SampleSet
from cnn_sr.training.trainer import init_train_state, train_loop
from cnn_sr.utils.config import parse_config

CFG = {
    "n1": 6, "n2": 3, "f1": 3, "f2": 1, "f3": 3,
    "momentum": 0.9, "weight_decay_parameter": 0.0001,
    "learning_rates": [0.01, 0.01, 0.001],
    **{
        f"parameters_distribution_{i}": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.0,
        }
        for i in (1, 2, 3)
    },
}


def _samples(n=7, size=14, seed=0):
    rng = np.random.default_rng(seed)
    inp = rng.standard_normal((n, size, size, 1)).astype(np.float32)
    exp = rng.uniform(0, 1, (n, size, size, 1)).astype(np.float32)
    return SampleSet(input_luma=inp, expected_luma=exp, width=size, height=size)


def test_scanned_dispatch_matches_per_epoch():
    cfg = parse_config(CFG)
    samples = _samples()

    logs_a, logs_b = [], []
    errs_a, errs_b = [], []

    state_a = init_train_state(cfg, seed=7)
    err = train_loop(
        cfg, samples, state_a, epochs=11, validation_cadence=3, seed=3,
        epochs_per_dispatch=1, log=logs_a.append,
        on_epoch=lambda e, v: errs_a.append((e, v)),
    )
    assert not err

    state_b = init_train_state(cfg, seed=7)
    err = train_loop(
        cfg, samples, state_b, epochs=11, validation_cadence=3, seed=3,
        epochs_per_dispatch=4, log=logs_b.append,
        on_epoch=lambda e, v: errs_b.append((e, v)),
    )
    assert not err

    assert state_a.epochs == state_b.epochs == 11
    for a, b in zip(state_a.params, state_b.params):
        np.testing.assert_allclose(a["w"], b["w"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a["b"], b["b"], rtol=1e-5, atol=1e-6)
    for a, b in zip(state_a.prev_delta, state_b.prev_delta):
        np.testing.assert_allclose(a["w"], b["w"], rtol=1e-5, atol=1e-6)

    # same validation epochs, same values
    assert [e for e, v in errs_a if v is not None] == [
        e for e, v in errs_b if v is not None
    ]
    va = [v for _, v in errs_a if v is not None]
    vb = [v for _, v in errs_b if v is not None]
    np.testing.assert_allclose(va, vb, rtol=1e-4)


def test_scanned_dispatch_nan_abort():
    raw = dict(CFG)
    raw["learning_rates"] = [1e6, 1e6, 1e6]
    cfg = parse_config(raw)
    samples = _samples(seed=1)
    state = init_train_state(cfg, seed=0)
    logs = []
    err = train_loop(
        cfg, samples, state, epochs=20, validation_cadence=1, seed=0,
        epochs_per_dispatch=5, log=logs.append,
    )
    assert err
    assert any("NAN" in l for l in logs)
