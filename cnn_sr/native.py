"""ctypes bindings for the native runtime library (``native/``).

The native layer mirrors the reference's C++ host runtime (stb image IO,
gason JSON, the prepare_image sample loop — SURVEY.md §2.1) with a
pthread-pooled batch sample loader, libjpeg/libpng codecs, fused
luma-extract + mean-subtract, and a fast float-JSON codec.

Everything degrades gracefully: if ``libcnnsr_native.so`` has not been
built (``make -C native``), ``AVAILABLE`` is False and callers fall back
to the Python paths. The library is built on first use when a compiler
and the libjpeg/libpng headers are present (best effort, silent on
failure); it is never committed, because ``-march=native`` ties it to
the machine that built it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcnnsr_native.so")

_lib = None


def _rebuild(stale: bool = False) -> None:
    """Build the library from source. Processes that start at once (test
    workers) take turns under a file lock, and each build is written to
    a private name and renamed into place, so no process ever loads a
    half-written library."""
    if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        return
    import fcntl

    try:
        with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(_LIB_PATH) and not stale:
                return  # another process built it while we waited
            tmp = f"libcnnsr_native.so.{os.getpid()}.tmp"
            subprocess.run(
                ["make", "-B", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
                capture_output=True, timeout=120, check=False,
            )
            if os.path.exists(os.path.join(_NATIVE_DIR, tmp)):
                os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        pass  # no compiler or headers: callers use the Python paths


def _try_load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _rebuild()
    if os.path.exists(_LIB_PATH):
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            if not hasattr(lib, "cnnsr_encode_jpeg"):
                # stale library from before a symbol was added — rebuild
                del lib
                _rebuild(stale=True)
                lib = ctypes.CDLL(_LIB_PATH)
            lib.cnnsr_image_size.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.cnnsr_image_size.restype = ctypes.c_int
            lib.cnnsr_decode_rgba.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.cnnsr_decode_rgba.restype = ctypes.c_int
            lib.cnnsr_encode_jpeg.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
            lib.cnnsr_encode_jpeg.restype = ctypes.c_int
            lib.cnnsr_extract_luma.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int]
            lib.cnnsr_load_sample_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.cnnsr_load_sample_batch.restype = ctypes.c_int
            lib.cnnsr_format_floats.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
            lib.cnnsr_format_floats.restype = ctypes.c_int64
            lib.cnnsr_parse_floats.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
            lib.cnnsr_parse_floats.restype = ctypes.c_int64
            _lib = lib
        except (OSError, AttributeError):
            # unloadable or still missing symbols after a rebuild attempt:
            # degrade gracefully to the PIL/numpy paths
            _lib = False
    else:
        _lib = False
    return _lib


def available() -> bool:
    return bool(_try_load())


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of an image file."""
    lib = _try_load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.cnnsr_image_size(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"cannot decode '{path}' (rc={rc})")
    return w.value, h.value


def decode_rgba(path: str) -> np.ndarray:
    """Decode JPEG/PNG to uint8 RGBA (H, W, 4) via the native codecs."""
    lib = _try_load()
    w, h = image_size(path)
    out = np.empty((h, w, 4), dtype=np.uint8)
    rc = lib.cnnsr_decode_rgba(path.encode(), out.ctypes.data, w, h)
    if rc != 0:
        raise IOError(f"cannot decode '{path}' (rc={rc})")
    return out


def encode_jpeg(path: str, rgb: np.ndarray, quality: int = 92) -> None:
    """Encode uint8 RGB (H, W, 3) as JPEG at the given quality."""
    lib = _try_load()
    arr = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = arr.shape[:2]
    rc = lib.cnnsr_encode_jpeg(path.encode(), arr.ctypes.data, w, h, quality)
    if rc != 0:
        raise IOError(f"cannot write '{path}' (rc={rc})")


def extract_luma(rgba: np.ndarray, normalize: bool = True,
                 subtract_mean: bool = False) -> np.ndarray:
    """Rec.601 luma (optionally /255 and mean-subtracted) from uint8 RGBA."""
    lib = _try_load()
    arr = np.ascontiguousarray(rgba, dtype=np.uint8)
    h, w = arr.shape[:2]
    out = np.empty((h, w), dtype=np.float32)
    lib.cnnsr_extract_luma(arr.ctypes.data, out.ctypes.data, h * w,
                           int(normalize), int(subtract_mean))
    return out


def load_sample_batch(
    paths: Sequence[str], width: int, height: int,
    normalize: bool = True, subtract_mean: bool = False,
    n_threads: int = 0,
) -> np.ndarray:
    """Threaded decode + luma-extract of many same-sized images into one
    packed (S, H, W) float32 array — the native training data loader."""
    lib = _try_load()
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    out = np.empty((len(paths), height, width), dtype=np.float32)
    rc = lib.cnnsr_load_sample_batch(
        blob, len(paths), width, height, out.ctypes.data,
        int(normalize), int(subtract_mean), n_threads,
    )
    if rc != 0:
        raise IOError(f"native sample batch load failed (rc={rc})")
    return out


def format_floats(vals: np.ndarray) -> str:
    """Serialize a float32 array as 'v, v, v' with round-trip precision."""
    lib = _try_load()
    arr = np.ascontiguousarray(vals, dtype=np.float32).ravel()
    cap = arr.size * 24 + 16
    buf = ctypes.create_string_buffer(cap)
    n = lib.cnnsr_format_floats(arr.ctypes.data, arr.size, buf, cap)
    if n < 0:
        raise ValueError("format_floats buffer overflow")
    return buf.raw[:n].decode()


def parse_floats(text: str, count: int) -> np.ndarray:
    """Parse ``count`` comma-separated floats."""
    lib = _try_load()
    out = np.empty(count, dtype=np.float32)
    n = lib.cnnsr_parse_floats(text.encode(), out.ctypes.data, count)
    if n != count:
        raise ValueError(f"expected {count} floats, parsed {n}")
    return out
