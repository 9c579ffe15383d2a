"""THE parity test: jax.grad of loss_sum must reproduce the reference's
hand-derived backprop chain (last_layer_delta.cl → layer_deltas.cl →
backpropagate.cl), including the ReLU' gate on the linear last layer and
raw summation over the sample axis.

This is the analog of LayerDeltasTest + BackpropagationTest
(SURVEY.md §4), with the numpy oracles standing in for the reference's
oracle scripts.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cnn_sr.models import loss_sum
from cnn_sr.models.srcnn import relu_backprop_gate

import oracles


def _oracle_grads(params_np, xs, gts):
    """Manual backprop summed over all samples, per the reference kernels."""
    n_layers = len(params_np)
    gws = [np.zeros_like(p["w"], dtype=np.float64) for p in params_np]
    gbs = [np.zeros_like(p["b"], dtype=np.float64) for p in params_np]
    for x, gt in zip(xs, gts):
        # forward, keeping activations
        acts = [x]
        for i, p in enumerate(params_np):
            acts.append(
                oracles.conv_forward(acts[-1], p["w"], p["b"], relu=(i != n_layers - 1))
            )
        # last layer delta: (y − gt_crop)·(y>0), single output channel
        y_last = acts[-1][..., 0]
        deltas = [None] * n_layers
        deltas[-1] = oracles.last_layer_delta(y_last, gt)[..., None]
        # propagate down: delta_l = full-corr(delta_{l+1}, w_{l+1})·relu'(y_l)
        for l in range(n_layers - 2, -1, -1):
            deltas[l] = oracles.layer_deltas(
                deltas[l + 1], acts[l + 1], params_np[l + 1]["w"]
            )
        # per-layer gradients vs that layer's *input*
        for l in range(n_layers):
            gw, gb = oracles.backprop_grads(
                deltas[l], acts[l], params_np[l]["w"].shape[0]
            )
            gws[l] += gw
            gbs[l] += gb
    return gws, gbs


@pytest.mark.parametrize("seed", [0, 1])
def test_jax_grad_matches_reference_backprop(seed):
    rng = np.random.default_rng(seed)
    specs = [(3, 1, 4), (1, 4, 3), (3, 3, 1)]  # (f, k, n) per layer
    params_np = [
        {
            "w": (rng.standard_normal((f, f, k, n)) * 0.4).astype(np.float32),
            "b": (rng.standard_normal((n,)) * 0.1).astype(np.float32),
        }
        for (f, k, n) in specs
    ]
    S, H, W = 3, 9, 8
    xs = rng.standard_normal((S, H, W, 1)).astype(np.float32)
    gts = rng.uniform(0, 1, size=(S, H, W)).astype(np.float32)

    params = jax.tree.map(jnp.asarray, params_np)
    grads = jax.grad(loss_sum)(params, jnp.asarray(xs), jnp.asarray(gts)[..., None])

    gws, gbs = _oracle_grads(params_np, xs, gts)
    for l in range(3):
        np.testing.assert_allclose(
            np.asarray(grads[l]["w"]), gws[l], rtol=2e-4, atol=2e-4,
            err_msg=f"grad_w mismatch at layer {l + 1}",
        )
        np.testing.assert_allclose(
            np.asarray(grads[l]["b"]), gbs[l], rtol=2e-4, atol=2e-4,
            err_msg=f"grad_b mismatch at layer {l + 1}",
        )


def test_relu_gate_quirk_zeroes_negative_output_grads():
    """The last layer is linear yet its delta is gated by (y>0)
    (last_layer_delta.cl:42-47 vs SKIP_RELU forward)."""
    y = jnp.asarray([[-1.0, 2.0], [0.0, -3.0]])

    def f(y):
        return jnp.sum(relu_backprop_gate(y) * jnp.asarray([[1.0, 10.0], [100.0, 1000.0]]))

    g = jax.grad(f)(y)
    np.testing.assert_array_equal(np.asarray(g), [[0.0, 10.0], [0.0, 0.0]])


def test_grad_sums_over_samples():
    """Gradients are raw sums across the sample axis (the reference
    accumulates all mini-batches into one grad buffer before the single
    per-epoch update — ConfigBasedDataPipeline.cpp:128-195)."""
    rng = np.random.default_rng(3)
    params = [
        {
            "w": jnp.asarray((rng.standard_normal((3, 3, 1, 1)) * 0.5).astype(np.float32)),
            "b": jnp.asarray(np.zeros(1, dtype=np.float32)),
        }
    ]
    xs = rng.standard_normal((4, 6, 6, 1)).astype(np.float32)
    gts = rng.uniform(0, 1, (4, 6, 6, 1)).astype(np.float32)

    g_all = jax.grad(loss_sum)(params, jnp.asarray(xs), jnp.asarray(gts))
    g_sum = None
    for i in range(4):
        gi = jax.grad(loss_sum)(
            params, jnp.asarray(xs[i : i + 1]), jnp.asarray(gts[i : i + 1])
        )
        g_sum = gi if g_sum is None else jax.tree.map(lambda a, b: a + b, g_sum, gi)
    np.testing.assert_allclose(
        np.asarray(g_all[0]["w"]), np.asarray(g_sum[0]["w"]), rtol=1e-5, atol=1e-6
    )
