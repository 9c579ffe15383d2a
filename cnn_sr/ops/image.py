"""Host-side image decode/encode (the pipeline's disk edges).

Equivalent of the reference's stb-based IO (UtilsOpenCL.cpp:88-123):

* ``load_image``  ≙ opencl::utils::load_image — decode to uint8 RGBA
  (stbi_load with 4 requested channels);
* ``write_image`` ≙ opencl::utils::write_image — encode by extension;
* ``write_greyscale_image`` ≙ the float-array → min-max-normalized
  greyscale PNG helper (UtilsOpenCL.cpp:97-123), used by weight
  visualization and debugging.

Decoding takes the fastest codec present: the native libjpeg/libpng
library when it is built (files only), then Pillow when it is installed,
then the standard-library PNG codec in ``ops.png`` (several times
slower: it undoes the row filters in numpy). PNG is always encoded by
``ops.png``, which is as fast as libpng and Pillow (all three spend
their time in zlib). So the upscaling path reads and writes PNG with nothing
beyond numpy and JAX. JPEG is written by the native library, and other
formats by Pillow.

These run on host; device transfer happens implicitly when the arrays
enter a jitted function (the only host↔device crossings in the pipeline,
matching the reference's single upload/readback per image).
"""

from __future__ import annotations

import functools
import importlib.util
import io

import numpy as np

from . import png


@functools.lru_cache(maxsize=None)
def _have_pillow() -> bool:
    try:
        return importlib.util.find_spec("PIL") is not None
    except ImportError:
        return False


def _pil_rgba(src) -> np.ndarray:
    from PIL import Image

    with Image.open(src) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Decode an encoded image held in memory to uint8 RGBA (H, W, 4):
    Pillow when installed, else the built-in PNG codec."""
    if data.startswith(png.SIGNATURE) and not _have_pillow():
        return png.decode_png(data)
    return _pil_rgba(io.BytesIO(data))


def load_image(path: str) -> np.ndarray:
    """Decode an image file to uint8 RGBA (H, W, 4)."""
    try:
        from .. import native

        if native.available():
            return native.decode_rgba(path)
    except (IOError, OSError):
        pass  # unsupported format or native decode failure
    with open(path, "rb") as f:
        return decode_image_bytes(f.read())


def _write(path: str, arr: np.ndarray) -> None:
    lower = path.lower()
    if lower.endswith(".png"):
        with open(path, "wb") as f:
            f.write(png.encode_png(arr))
        return
    if lower.endswith((".jpg", ".jpeg")) and arr.ndim == 3:
        try:
            from .. import native

            if native.available():
                native.encode_jpeg(path, arr)
                return
        except (IOError, OSError):
            pass
    from PIL import Image

    Image.fromarray(arr).save(path)


def write_image(path: str, rgb: np.ndarray) -> None:
    """Encode a uint8 (H, W, 3) array by extension: PNG with the built-in
    codec, JPEG with the native encoder when built, else Pillow."""
    _write(path, np.ascontiguousarray(rgb, dtype=np.uint8))


def write_greyscale_image(path: str, data: np.ndarray) -> None:
    """Min-max-normalize a float array (H, W) to 0..255 greyscale and
    write it (UtilsOpenCL.cpp:97-123)."""
    arr = np.asarray(data, dtype=np.float32)
    lo, hi = float(arr.min()), float(arr.max())
    if hi > lo:
        norm = (arr - lo) / (hi - lo)
    else:
        norm = np.full_like(arr, 0.5)
    _write(path, (norm * 255.0).astype(np.uint8))
