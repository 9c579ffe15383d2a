"""Native runtime library tests: codecs and batch loader must agree with
the PIL/numpy reference paths bit-for-bit (uint8) / to float tolerance."""

import os

import numpy as np
import pytest
from PIL import Image

from cnn_sr import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


@pytest.fixture
def png_path(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    Image.fromarray(img, "RGB").save(p)
    return p, img


def test_decode_png_matches_pil(png_path):
    p, img = png_path
    got = native.decode_rgba(p)
    want = np.asarray(Image.open(p).convert("RGBA"))
    np.testing.assert_array_equal(got, want)
    assert native.image_size(p) == (53, 37)


def test_decode_jpeg_matches_pil_closely(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    p = str(tmp_path / "t.jpg")
    Image.fromarray(img, "RGB").save(p, "JPEG", quality=95)
    got = native.decode_rgba(p).astype(np.int32)
    want = np.asarray(Image.open(p).convert("RGBA")).astype(np.int32)
    # libjpeg IDCT variants may differ by a couple of LSBs from PIL's
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2


def test_encode_jpeg_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    # smooth gradient (JPEG is lossy; keep the content compressible)
    y = np.linspace(0, 255, 24, dtype=np.float32)[:, None, None]
    x = np.linspace(0, 255, 32, dtype=np.float32)[None, :, None]
    rgb = np.clip((y + x) / 2 + rng.normal(0, 2, (24, 32, 3)), 0, 255
                  ).astype(np.uint8)
    p = str(tmp_path / "out.jpg")
    native.encode_jpeg(p, rgb, quality=95)
    back = np.asarray(Image.open(p).convert("RGB")).astype(np.int32)
    assert back.shape == rgb.shape
    assert np.abs(back - rgb.astype(np.int32)).mean() < 6.0

    # write_image routes .jpg through the native encoder
    from cnn_sr.ops.image import write_image

    p2 = str(tmp_path / "out2.jpeg")
    write_image(p2, rgb)
    back2 = np.asarray(Image.open(p2).convert("RGB"))
    assert back2.shape == rgb.shape


def test_extract_luma_matches_numpy():
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (25, 31, 4), dtype=np.uint8)
    got = native.extract_luma(rgba, normalize=True, subtract_mean=False)
    px = rgba[..., :3].astype(np.float64)
    want = (0.299 * px[..., 0] + 0.587 * px[..., 1] + 0.114 * px[..., 2]) / 255.0
    np.testing.assert_allclose(got, want, atol=1e-5)

    got_zm = native.extract_luma(rgba, normalize=True, subtract_mean=True)
    np.testing.assert_allclose(got_zm, want - want.mean(), atol=1e-5)
    assert abs(got_zm.mean()) < 1e-5


def test_batch_loader_matches_single(tmp_path):
    rng = np.random.default_rng(4)
    paths = []
    imgs = []
    for i in range(6):
        img = rng.integers(0, 256, (16, 22, 3), dtype=np.uint8)
        p = str(tmp_path / f"s{i}.png")
        Image.fromarray(img, "RGB").save(p)
        paths.append(p)
        imgs.append(img)
    batch = native.load_sample_batch(paths, 22, 16, normalize=True, subtract_mean=True)
    assert batch.shape == (6, 16, 22)
    for i, img in enumerate(imgs):
        rgba = np.dstack([img, np.full(img.shape[:2], 255, np.uint8)])
        single = native.extract_luma(rgba, normalize=True, subtract_mean=True)
        np.testing.assert_allclose(batch[i], single, atol=1e-6)


def test_batch_loader_size_mismatch(tmp_path):
    p = str(tmp_path / "bad.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8), "RGB").save(p)
    with pytest.raises(IOError):
        native.load_sample_batch([p], 22, 16)


def test_float_json_codec_roundtrip():
    rng = np.random.default_rng(5)
    vals = rng.standard_normal(10_000).astype(np.float32) * 1e3
    vals[0], vals[1], vals[2] = 0.0, -0.0, 1e-38
    text = native.format_floats(vals)
    back = native.parse_floats(text, vals.size)
    np.testing.assert_array_equal(back, vals)  # bit-exact round trip


def test_sample_set_native_matches_pil_path(tmp_path, monkeypatch):
    """load_sample_set via the native fast path must equal the PIL path."""
    from cnn_sr.training import samples as S

    rng = np.random.default_rng(6)
    d = tmp_path / "s"
    os.makedirs(str(d))
    for i in range(3):
        large = rng.integers(0, 256, (14, 14, 3), dtype=np.uint8)
        small = ((large.astype(np.float32) + np.roll(large, 1, 0)) / 2).astype(np.uint8)
        Image.fromarray(large, "RGB").save(str(d / f"x{i}_large.png"))
        Image.fromarray(small, "RGB").save(str(d / f"x{i}_small.png"))
    pairs = S.find_training_samples(str(d))

    native_set = S.load_sample_set(pairs)
    monkeypatch.setattr(S, "_load_sample_set_native", lambda pairs: None)
    pil_set = S.load_sample_set(pairs)

    np.testing.assert_allclose(
        native_set.input_luma, pil_set.input_luma, atol=2e-5
    )
    np.testing.assert_allclose(
        native_set.expected_luma, pil_set.expected_luma, atol=2e-5
    )
