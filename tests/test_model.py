"""Model forward tests vs the numpy oracle — the reference's LayerTest
(data-driven conv configs incl. f=1, LayerTest.cpp:16-21 /
LayerTest_script.R) rebuilt as property tests over the same shape matrix."""

import numpy as np
import pytest

import jax.numpy as jnp

from cnn_sr.models import center_crop, forward
from cnn_sr.models.srcnn import conv_layer, forward_activations

import oracles


# the reference's three LayerTest datasets' shape configs (test_cases.json):
# (k, n, f, input_w, input_h)
LAYER_CASES = [
    (1, 3, 3, 5, 5),
    (3, 2, 3, 3, 3),
    (3, 3, 1, 3, 3),
    (2, 4, 5, 9, 7),   # extra: rectangular input, f=5
]


@pytest.mark.parametrize("k,n,f,w_dim,h_dim", LAYER_CASES)
@pytest.mark.parametrize("relu", [True, False])
def test_conv_layer_matches_oracle(k, n, f, w_dim, h_dim, relu):
    rng = np.random.default_rng(hash((k, n, f, relu)) % 2**32)
    inp = rng.standard_normal((h_dim, w_dim, k)).astype(np.float32)
    w = rng.standard_normal((f, f, k, n)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)

    want = oracles.conv_forward(inp, w, b, relu)
    got = conv_layer(jnp.asarray(inp)[None], jnp.asarray(w), jnp.asarray(b), relu)[0]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,n,f,w_dim,h_dim", LAYER_CASES)
def test_vectorized_oracle_matches_loop(k, n, f, w_dim, h_dim):
    """conv_forward_vec (einsum, used at flagship scale) must reproduce
    the loop-level oracle exactly — guards the vectorization itself."""
    rng = np.random.default_rng(hash((k, n, f, "vec")) % 2**32)
    inp = rng.standard_normal((h_dim, w_dim, k)).astype(np.float32)
    w = rng.standard_normal((f, f, k, n)).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32)
    for relu in (True, False):
        # identical f64 math, different summation order (einsum pairwise
        # vs serial loop) → agreement to the last f32 ulp, not bit-equal
        np.testing.assert_allclose(
            oracles.conv_forward_vec(inp, w, b, relu),
            oracles.conv_forward(inp, w, b, relu),
            rtol=1e-6, atol=1e-6,
        )


def test_vectorized_swap_luma_matches_loop():
    rng = np.random.default_rng(99)
    img = rng.integers(0, 256, (12, 14, 4), dtype=np.uint8)
    luma = rng.uniform(-0.2, 1.2, (8, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        oracles.swap_luma_vec(img, luma), oracles.swap_luma(img, luma))


def _random_params(rng, specs):
    return [
        {
            "w": jnp.asarray(
                rng.standard_normal((f, f, k, n)).astype(np.float32) * 0.3
            ),
            "b": jnp.asarray(rng.standard_normal((n,)).astype(np.float32) * 0.1),
        }
        for (f, k, n) in specs
    ]


def test_three_layer_forward_matches_chained_oracle():
    # SRCNN stack: 1→4 (f=3, relu), 4→2 (f=1, relu), 2→1 (f=3, linear)
    rng = np.random.default_rng(11)
    specs = [(3, 1, 4), (1, 4, 2), (3, 2, 1)]
    params = _random_params(rng, specs)
    x = rng.standard_normal((10, 12, 1)).astype(np.float32)

    a = oracles.conv_forward(x, np.asarray(params[0]["w"]), np.asarray(params[0]["b"]), True)
    a = oracles.conv_forward(a, np.asarray(params[1]["w"]), np.asarray(params[1]["b"]), True)
    want = oracles.conv_forward(a, np.asarray(params[2]["w"]), np.asarray(params[2]["b"]), False)

    got = forward(params, jnp.asarray(x)[None])[0]
    assert got.shape == want.shape == (10 - 2 - 0 - 2, 12 - 2 - 0 - 2, 1)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)

    acts = forward_activations(params, jnp.asarray(x)[None])
    assert len(acts) == 3
    np.testing.assert_allclose(np.asarray(acts[-1][0]), want, rtol=1e-4, atol=1e-5)


def test_center_crop_offsets():
    gt = jnp.arange(8 * 10, dtype=jnp.float32).reshape(1, 8, 10, 1)
    out = center_crop(gt, 4, 6)
    assert out.shape == (1, 4, 6, 1)
    # offset (8-4)//2 = 2 rows, (10-6)//2 = 2 cols
    assert float(out[0, 0, 0, 0]) == float(gt[0, 2, 2, 0])


def test_batched_forward_matches_per_sample():
    rng = np.random.default_rng(5)
    specs = [(3, 1, 4), (3, 4, 1)]
    params = _random_params(rng, specs)
    xs = rng.standard_normal((3, 9, 9, 1)).astype(np.float32)
    batched = forward(params, jnp.asarray(xs))
    for i in range(3):
        single = forward(params, jnp.asarray(xs[i])[None])[0]
        np.testing.assert_allclose(
            np.asarray(batched[i]), np.asarray(single), rtol=1e-6, atol=1e-6
        )
