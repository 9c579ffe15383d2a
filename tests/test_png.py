"""The standard-library PNG codec (``cnn_sr.ops.png``) against Pillow:
every committed PNG decodes to Pillow's ``convert("RGBA")`` pixels, our
encoder's output reads back identically in both decoders, and broken
input is refused."""

import glob
import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from cnn_sr.ops import png
from cnn_sr.ops.image import decode_image_bytes, load_image, write_image

TESTS = os.path.dirname(os.path.abspath(__file__))
COMMITTED = sorted(
    glob.glob(os.path.join(TESTS, "refdata", "*.png"))
    + glob.glob(os.path.join(TESTS, "golden", "*.png")))


def _pil_rgba(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


def _pil_png(arr, mode, **save) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG", **save)
    return buf.getvalue()


@pytest.mark.parametrize("path", COMMITTED, ids=os.path.basename)
def test_committed_png_decodes_like_pillow(path):
    """Files written by Pillow and stb use all five scanline filters."""
    with open(path, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(png.decode_png(data), _pil_rgba(data))
    np.testing.assert_array_equal(load_image(path), _pil_rgba(data))


def test_committed_set_is_nonempty():
    assert len(COMMITTED) >= 4


@pytest.mark.parametrize("mode,channels", [
    ("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)])
def test_round_trip(mode, channels):
    rng = np.random.default_rng(channels)
    shape = (23, 17) if channels == 1 else (23, 17, channels)
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    ours = png.encode_png(arr)
    got = png.decode_png(ours)
    np.testing.assert_array_equal(got, _pil_rgba(ours))
    # and Pillow's encoding of the same pixels decodes identically
    np.testing.assert_array_equal(png.decode_png(_pil_png(arr, mode)), got)


def test_palette_and_transparency_match_pillow():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
    pal = Image.fromarray(rgb).quantize(100)
    buf = io.BytesIO()
    pal.save(buf, "PNG", transparency=bytes(range(0, 250, 5)))
    cases = [buf.getvalue(),
             _pil_png(rng.integers(0, 4, (9, 13), dtype=np.uint8), "L",
                      transparency=2),
             _pil_png(rng.integers(0, 3, (9, 13, 3), dtype=np.uint8), "RGB",
                      transparency=(1, 2, 0))]
    for data in cases:
        np.testing.assert_array_equal(png.decode_png(data), _pil_rgba(data))


def test_broken_png_is_refused():
    data = bytearray(png.encode_png(np.zeros((4, 5, 3), np.uint8)))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(data[6:]))
    flipped = bytearray(data)
    flipped[20] ^= 0xFF  # inside IHDR: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(flipped))
    with pytest.raises(ValueError, match="truncated"):
        png.decode_png(bytes(data[:-20]))
    # a header claiming more pixels than the bound is refused unread
    ihdr = struct.pack(">IIBBBBB", 100000, 100000, 8, 2, 0, 0, 0)
    bomb = (png.SIGNATURE + struct.pack(">I", 13) + b"IHDR" + ihdr
            + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr))
            + struct.pack(">I", 0) + b"IEND"
            + struct.pack(">I", zlib.crc32(b"IEND")))
    with pytest.raises(ValueError, match="exceeds"):
        png.decode_png(bomb)


def test_unsupported_variant_falls_back_to_pillow(tmp_path):
    """16-bit PNGs are outside the codec's scope: ``decode_png`` says so,
    and the image layer hands them to Pillow."""
    arr = np.random.default_rng(3).integers(0, 65536, (6, 7), dtype=np.uint16)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    with pytest.raises(png.UnsupportedPNG):
        png.decode_png(buf.getvalue())
    assert decode_image_bytes(buf.getvalue()).shape == (6, 7, 4)


def test_write_image_png_reads_back(tmp_path):
    rgb = np.random.default_rng(4).integers(0, 256, (19, 21, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_image(path, rgb)
    np.testing.assert_array_equal(load_image(path)[..., :3], rgb)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), rgb)


@pytest.mark.parametrize("pillow", [True, False], ids=["pillow", "no-pillow"])
def test_decode_image_bytes_with_and_without_pillow(pillow, monkeypatch):
    """In-memory decoding uses Pillow when it is installed and the
    built-in codec otherwise; both give Pillow's pixels."""
    from cnn_sr.ops import image

    monkeypatch.setattr(image, "_have_pillow", lambda: pillow)
    rng = np.random.default_rng(6)
    for arr, mode in ((rng.integers(0, 256, (13, 29, 3), dtype=np.uint8), "RGB"),
                      (rng.integers(0, 256, (13, 29), dtype=np.uint8), "L")):
        for data in (png.encode_png(arr), _pil_png(arr, mode)):
            np.testing.assert_array_equal(image.decode_image_bytes(data),
                                          _pil_rgba(data))


@pytest.mark.parametrize("native_lib,pillow", [
    (True, True), (False, True), (False, False)],
    ids=["native", "pillow", "builtin"])
def test_files_round_trip_through_each_decoder(native_lib, pillow, monkeypatch,
                                               tmp_path):
    """``load_image`` decodes with the native library, else Pillow, else
    the built-in codec; each reads back what ``write_image`` wrote."""
    from cnn_sr import native
    from cnn_sr.ops import image

    if native_lib and not native.available():
        pytest.skip("native library not built")
    monkeypatch.setattr(native, "available", lambda: native_lib)
    monkeypatch.setattr(image, "_have_pillow", lambda: pillow)
    rgb = np.random.default_rng(7).integers(0, 256, (17, 11, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_image(path, rgb)
    np.testing.assert_array_equal(load_image(path)[..., :3], rgb)
