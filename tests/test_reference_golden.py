"""Parity tests against the reference's OWN committed golden data.

Round-1 parity evidence rested on repo-authored numpy oracles. These tests
instead assert against numeric vectors and images committed in the upstream
repository (transcribed data, not code — provenance below):

- ``tests/refdata/test_cases.json``  == ``/root/reference/test/data/test_cases.json``
  (three conv datasets with expected outputs; consumed by
  ``test/specs/LayerTest.cpp:16-21``, layout documented at
  ``LayerTest.cpp:20-48``: input is point-major channel-fastest, weights are
  ``[f,f,k,n]`` n-fastest, outputs point-major n-fastest, ReLU applied —
  ``LayerTest.cpp:124`` passes ``skip_relu=false``).
- ``tests/refdata/color_grid.png``   == ``/root/reference/test/data/color_grid.png``
  with the hardcoded 5x5 luma vector from ``test/specs/ExtractLumaTest.cpp:22-33``
  (normalized; the un-normalized variant multiplies by 255 —
  ``ExtractLumaTest.cpp:68-70``).
- ``tests/refdata/color_grid2.jpg`` / ``color_grid2_luma_swapped.png``
  == the SwapLumaTest golden pair (``test/specs/SwapLumaTest.cpp:20-89``):
  a deterministic luma ramp is swapped into the jpg and the result must be
  pixel-exact against the committed PNG.

Tolerance: the reference's float compare uses margin 0.005 for |expected|<=10
(``test/TestCase.cpp:48-55``); we use the stricter symmetric ``atol=0.005``.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp

from cnn_sr.models.srcnn import conv_layer
from cnn_sr.ops.color import extract_luma, swap_luma

REFDATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "refdata")


def _load_cases():
    with open(os.path.join(REFDATA, "test_cases.json")) as f:
        raw = json.load(f)
    cases = []
    for name, d in raw.items():
        k = d["n_prev_filter_cnt"]
        n = d["current_filter_count"]
        f_sz = d["f_spatial_size"]
        w_dim, h_dim = d["input_w"], d["input_h"]
        out_h, out_w = h_dim - f_sz + 1, w_dim - f_sz + 1
        # LayerTest.cpp:27-30 — "Each column for different filter, each row
        # for different point": point-major, channel-fastest -> (H, W, k)
        inp = np.asarray(d["input"], np.float32).reshape(h_dim, w_dim, k)
        # LayerTest.cpp:36-41 — f*f paragraphs/rows, each row k groups of n
        # numbers -> [f, f, k, n] n-fastest (the repo's weight contract)
        wts = np.asarray(d["weights"], np.float32).reshape(f_sz, f_sz, k, n)
        bias = np.asarray(d["bias"], np.float32)
        out = np.asarray(d["output"], np.float32).reshape(out_h, out_w, n)
        cases.append(pytest.param(inp, wts, bias, out, id=name))
    return cases


@pytest.mark.parametrize("inp,wts,bias,want", _load_cases())
def test_conv_layer_reproduces_reference_committed_outputs(inp, wts, bias, want):
    got = conv_layer(jnp.asarray(inp)[None], jnp.asarray(wts), jnp.asarray(bias), relu=True)[0]
    np.testing.assert_allclose(np.asarray(got), want, atol=0.005, rtol=0)


# ExtractLumaTest.cpp:22-33 — hardcoded expected luma of color_grid.png (5x5)
_EXTRACT_LUMA_GOLDEN = np.asarray(
    [
        [0.000, 1.000, 0.812, 0.853, 0.437],
        [0.170, 0.701, 0.413, 0.886, 0.787],
        [0.430, 0.299, 0.587, 0.114, 0.707],
        [0.670, 0.745, 0.853, 0.745, 0.299],
        [0.810, 0.588, 0.859, 0.593, 0.702],
    ],
    dtype=np.float32,
)


@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "raw"])
def test_extract_luma_reference_golden_vector(normalize):
    img = np.asarray(Image.open(os.path.join(REFDATA, "color_grid.png")).convert("RGB"))
    assert img.shape == (5, 5, 3)
    want = _EXTRACT_LUMA_GOLDEN if normalize else _EXTRACT_LUMA_GOLDEN * 255.0
    got = np.asarray(extract_luma(jnp.asarray(img), normalize=normalize))
    # golden values are printed to 3 decimals; reference margin is 0.005
    # (x255 for the raw variant, matching TestCase.cpp's >100 -> margin 1)
    atol = 0.005 if normalize else 1.0
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _swap_ramp(img: np.ndarray) -> np.ndarray:
    """Reproduce SwapLumaTest.cpp:39-60: a deterministic luma ramp swapped
    into the (already decoded) test image."""
    h, w = img.shape[0], img.shape[1]
    padding = 10  # SwapLumaTest.cpp:21
    luma_w, luma_h = w - 2 * padding, h - 2 * padding
    n_luma = luma_w * luma_w  # sic — the reference sizes by width twice
    ramp = (np.arange(n_luma, dtype=np.float32) / n_luma).reshape(luma_h, luma_w)
    return np.asarray(swap_luma(jnp.asarray(img), jnp.asarray(ramp)))


def test_swap_luma_reference_golden_image_exact():
    """SwapLumaTest.cpp:39-89 — pixel-exact against the committed PNG.

    The reference decodes color_grid2.jpg with stb_image
    (UtilsOpenCL.cpp:88-89); PIL/libjpeg's IDCT differs from stb's by up to
    ±2 on ~2% of samples, so for exactness the input is
    ``color_grid2_stb_decode.png`` — a lossless capture of stb_image's
    decode of the committed jpg (verified byte-identical to the golden's
    untouched border ring, which IS stb's decode passed through).
    """
    img = np.asarray(
        Image.open(os.path.join(REFDATA, "color_grid2_stb_decode.png")).convert("RGB")
    )
    want = np.asarray(
        Image.open(os.path.join(REFDATA, "color_grid2_luma_swapped.png")).convert("RGB")
    )
    np.testing.assert_array_equal(_swap_ramp(img), want)


def test_swap_luma_reference_golden_image_via_libjpeg():
    """Same swap from PIL/libjpeg's decode of the jpg: bounded only by the
    JPEG-decoder fingerprint (±2 input delta; the border ring shows the
    same delta with no swap math involved)."""
    img = np.asarray(Image.open(os.path.join(REFDATA, "color_grid2.jpg")).convert("RGB"))
    got = _swap_ramp(img).astype(int)
    want = np.asarray(
        Image.open(os.path.join(REFDATA, "color_grid2_luma_swapped.png")).convert("RGB")
    ).astype(int)
    diff = np.abs(got - want)
    assert diff.max() <= 2, diff.max()
    assert (diff == 0).mean() >= 0.97
