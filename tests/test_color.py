"""Color op tests — ExtractLumaTest / SwapLumaTest rebuilt (SURVEY.md §4)
with numpy oracles instead of golden files, plus a deterministic golden
vector for a synthetic color grid."""

import numpy as np

import jax.numpy as jnp

from cnn_sr.ops import extract_luma, subtract_mean, swap_luma

import oracles


def _color_grid(h=5, w=5, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)


def test_extract_luma_normalized_and_raw():
    img = _color_grid()
    for normalize in (True, False):
        want = oracles.extract_luma(img, normalize)
        got = extract_luma(jnp.asarray(img), normalize=normalize)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-4)


def test_extract_luma_golden_values():
    # hand-computed Rec.601 values (the ExtractLumaTest golden-vector idea)
    img = np.zeros((1, 4, 4), dtype=np.uint8)
    img = np.stack(
        [
            np.array([[255, 0, 0, 255]], dtype=np.uint8),      # red
            np.array([[0, 255, 0, 255]], dtype=np.uint8),      # green
            np.array([[0, 0, 255, 255]], dtype=np.uint8),      # blue
            np.array([[255, 255, 255, 255]], dtype=np.uint8),  # white
        ],
        axis=1,
    )[0][None]
    got = np.asarray(extract_luma(jnp.asarray(img), normalize=False))[0]
    np.testing.assert_allclose(
        got, [0.299 * 255, 0.587 * 255, 0.114 * 255, 255.0], rtol=1e-5
    )


def test_subtract_mean():
    luma = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (6, 7)).astype(np.float32))
    zero_mean, mean = subtract_mean(luma)
    assert abs(float(jnp.mean(zero_mean))) < 1e-6
    np.testing.assert_allclose(float(mean), float(jnp.mean(luma)), rtol=1e-6)


def test_subtract_mean_squared_quirk():
    """``squared=True`` subtracts E[luma²] — the shipped reference
    binary's behavior (DataPipeline.cpp:268-280 passes a cl_event* into
    `bool squared`; proven bit-exact via tools/reforacle — see
    docs/REFERENCE_PARITY.md)."""
    luma = jnp.asarray(
        np.random.default_rng(2).uniform(0, 1, (6, 7)).astype(np.float32))
    zero_mean, mean = subtract_mean(luma, squared=True)
    want = float(jnp.mean(jnp.square(luma)))
    np.testing.assert_allclose(float(mean), want, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(zero_mean), np.asarray(luma) - want, rtol=1e-5)


def test_swap_luma_matches_oracle():
    img = _color_grid(8, 9, seed=3)
    # luma window smaller than the image → padding border passthrough
    new_luma = np.random.default_rng(4).uniform(0, 1, (4, 5)).astype(np.float32)
    want = oracles.swap_luma(img, new_luma)
    got = np.asarray(swap_luma(jnp.asarray(img), jnp.asarray(new_luma)))
    np.testing.assert_array_equal(got, want)


def test_swap_luma_border_passthrough():
    img = _color_grid(7, 7, seed=5)
    new_luma = np.full((3, 3), 0.5, dtype=np.float32)
    out = np.asarray(swap_luma(jnp.asarray(img), jnp.asarray(new_luma)))
    pad = (7 - 3) // 2
    # corners = original RGB
    np.testing.assert_array_equal(out[0, 0], img[0, 0, :3])
    np.testing.assert_array_equal(out[-1, -1], img[-1, -1, :3])
    # inside differs from original (luma replaced) for at least some pixel
    assert not np.array_equal(out[pad : pad + 3, pad : pad + 3], img[pad : pad + 3, pad : pad + 3, :3])


def test_swap_luma_identity_luma_reconstructs_image():
    """Swapping in the image's own (normalized) luma must approximately
    reconstruct the original: YCbCr round-trip sanity."""
    img = _color_grid(6, 6, seed=6)
    own_luma = oracles.extract_luma(img, normalize=True)
    out = np.asarray(swap_luma(jnp.asarray(img), jnp.asarray(own_luma)))
    # the fixed conversion matrices are only approximately inverse (and we
    # truncate), so allow a small per-channel tolerance
    diff = out.astype(np.int32) - img[..., :3].astype(np.int32)
    assert np.abs(diff).max() <= 3


# ---- byte-packed (uint32) color path: must match the rank-3 ops exactly ----

def test_extract_luma_packed_bit_identical():
    from cnn_sr.ops.color import extract_luma_packed, pack_rgba_host

    img = _color_grid(11, 7, seed=9)
    packed = pack_rgba_host(img)
    for norm in (True, False):
        a = np.asarray(extract_luma(jnp.asarray(img), normalize=norm))
        b = np.asarray(extract_luma_packed(jnp.asarray(packed), normalize=norm))
        np.testing.assert_array_equal(a, b)


def test_swap_luma_packed_bit_identical():
    from cnn_sr.ops.color import (
        pack_rgba_host, swap_luma_packed, unpack_rgb_host)

    img = _color_grid(9, 12, seed=10)
    rng = np.random.default_rng(0)
    new_luma = rng.random((5, 6)).astype(np.float32)
    want = np.asarray(swap_luma(jnp.asarray(img), jnp.asarray(new_luma)))
    got_u32 = np.asarray(
        swap_luma_packed(jnp.asarray(pack_rgba_host(img)), jnp.asarray(new_luma)))
    np.testing.assert_array_equal(unpack_rgb_host(got_u32), want)
    # alpha byte passes through untouched everywhere
    np.testing.assert_array_equal(
        got_u32 >> 24, img[..., 3].astype(np.uint32))


def test_pack_rgba_host_roundtrip_and_3ch():
    from cnn_sr.ops.color import pack_rgba_host, unpack_rgb_host

    img = _color_grid(4, 5, seed=11)
    np.testing.assert_array_equal(
        unpack_rgb_host(pack_rgba_host(img)), img[..., :3])
    # 3-channel input gains alpha=255
    p3 = pack_rgba_host(np.ascontiguousarray(img[..., :3]))
    np.testing.assert_array_equal(unpack_rgb_host(p3), img[..., :3])
    assert (np.asarray(p3) >> 24 == 255).all()
