"""Optimizer property test — UpdateParametersTest rebuilt
(UpdateParametersTest.cpp:28-102): random weights/grads/prev-deltas,
CPU recompute of the exact update rule including the un-divided
prev-delta side effect and no weight decay on bias."""

import numpy as np

import jax.numpy as jnp

from cnn_sr.optim import init_optimizer_state, update_parameters

import oracles


def test_update_matches_oracle():
    rng = np.random.default_rng(42)
    n_weights, n_bias = 20_000, 64
    momentum, wd, lr, bs = 0.9, 0.001, 1e-3, 17

    w = rng.standard_normal(n_weights).astype(np.float32)
    b = rng.standard_normal(n_bias).astype(np.float32)
    gw = rng.standard_normal(n_weights).astype(np.float32)
    gb = rng.standard_normal(n_bias).astype(np.float32)
    pw = rng.standard_normal(n_weights).astype(np.float32)
    pb = rng.standard_normal(n_bias).astype(np.float32)

    params = [{"w": jnp.asarray(w), "b": jnp.asarray(b)}]
    prev = [{"w": jnp.asarray(pw), "b": jnp.asarray(pb)}]
    grads = [{"w": jnp.asarray(gw), "b": jnp.asarray(gb)}]

    new_params, new_prev = update_parameters(
        params, prev, grads, [lr], momentum, wd, bs
    )

    ew, eb, epw, epb = oracles.update_params(w, b, gw, gb, pw, pb, momentum, wd, lr, bs)
    np.testing.assert_allclose(np.asarray(new_params[0]["w"]), ew, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(new_params[0]["b"]), eb, rtol=1e-6, atol=1e-7)
    # prev_delta stores the UN-divided delta (update_parameters.cl:24)
    np.testing.assert_allclose(np.asarray(new_prev[0]["w"]), epw, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(new_prev[0]["b"]), epb, rtol=1e-6, atol=1e-7)


def test_bias_has_no_weight_decay():
    params = [{"w": jnp.ones(4), "b": jnp.ones(2)}]
    prev = init_optimizer_state(params)
    grads = [{"w": jnp.zeros(4), "b": jnp.zeros(2)}]
    new_params, new_prev = update_parameters(
        params, prev, grads, [1.0], momentum=0.0, weight_decay=0.5, batch_size=1
    )
    # weights decay: w - (0.5·w)/1 = 0.5 ; bias untouched
    np.testing.assert_allclose(np.asarray(new_params[0]["w"]), 0.5)
    np.testing.assert_allclose(np.asarray(new_params[0]["b"]), 1.0)


def test_per_layer_learning_rates():
    params = [
        {"w": jnp.zeros(2), "b": jnp.zeros(1)},
        {"w": jnp.zeros(2), "b": jnp.zeros(1)},
    ]
    prev = init_optimizer_state(params)
    grads = [
        {"w": jnp.ones(2), "b": jnp.ones(1)},
        {"w": jnp.ones(2), "b": jnp.ones(1)},
    ]
    new_params, _ = update_parameters(
        params, prev, grads, [0.1, 0.01], momentum=0.0, weight_decay=0.0, batch_size=2
    )
    np.testing.assert_allclose(np.asarray(new_params[0]["w"]), -0.05)
    np.testing.assert_allclose(np.asarray(new_params[1]["w"]), -0.005)


def test_momentum_accumulates_across_steps():
    params = [{"w": jnp.zeros(1), "b": jnp.zeros(1)}]
    prev = init_optimizer_state(params)
    grads = [{"w": jnp.ones(1), "b": jnp.zeros(1)}]
    lrs, m = [1.0], 0.5
    # step 1: delta = 1.0 → w = -1 ; prev = 1
    params, prev = update_parameters(params, prev, grads, lrs, m, 0.0, 1)
    # step 2: delta = 0.5·1 + 1 = 1.5 → w = -2.5 ; prev = 1.5
    params, prev = update_parameters(params, prev, grads, lrs, m, 0.0, 1)
    np.testing.assert_allclose(np.asarray(params[0]["w"]), -2.5)
    np.testing.assert_allclose(np.asarray(prev[0]["w"]), 1.5)
