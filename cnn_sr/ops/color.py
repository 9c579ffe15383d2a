"""Color-space ops: luma extraction, mean subtraction, luma swap.

JAX equivalents of the reference's pre/post-processing kernels:

* ``extract_luma``  ≙ extract_luma.cl:5-21 — Rec.601 luma
  ``0.299·R + 0.587·G + 0.114·B`` from uint8 RGBA, optionally /255;
* ``subtract_mean`` ≙ DataPipeline::subtract_mean (DataPipeline.cpp:268-280:
  ``sum`` kernel + host divide + ``sub_from_all``) — here a single fused
  jnp expression with a deterministic XLA reduction instead of the
  reference's float-atomic tree reduction;
* ``swap_luma``     ≙ swap_luma.cl:19-69 — recombine the net's new luma
  (0..1) with the original image's chroma via the fixed YCbCr matrices
  (the ±128 chroma offsets cancel and are skipped, as in the reference),
  clamp to 0..255, truncate to uint8 (OpenCL convert_uint defaults to
  round-toward-zero); pixels outside the centered luma window copy the
  original image (the valid-conv padding border).

All are jit-friendly pure functions on arrays; image decode/encode lives
in ``cnn_sr.ops.image``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# Rec.601 matrices (swap_luma.cl:7-16; http://www.equasys.de/colorconversion.html)
RGB2Y = jnp.array([0.299, 0.587, 0.114], dtype=jnp.float32)
RGB2CB = jnp.array([-0.1687, -0.3312, 0.5], dtype=jnp.float32)
RGB2CR = jnp.array([0.5, -0.4186, -0.0813], dtype=jnp.float32)
# YCbCr -> RGB rows (swap_luma.cl:14-16)
YCBCR2R = jnp.array([1.0, 0.0, 1.4], dtype=jnp.float32)
YCBCR2G = jnp.array([1.0, -0.343, -0.711], dtype=jnp.float32)
YCBCR2B = jnp.array([1.0, 1.765, 0.0], dtype=jnp.float32)


def _luma_from_planes(r, g, b, normalize: bool):
    # shared by the rank-3 and byte-packed entry points so the two are
    # bit-identical by construction (same expression tree)
    luma = r * 0.299 + g * 0.587 + b * 0.114
    return luma / 255.0 if normalize else luma


def extract_luma(image: jnp.ndarray, normalize: bool = True) -> jnp.ndarray:
    """uint8 RGB(A) (H, W, C>=3) → float32 luma (H, W).

    ``normalize=True`` divides by 255 (the ``-D NORMALIZE`` kernel
    instance; the pipeline always uses the normalized one for model
    input — Main_cl.cpp:303-318).
    """
    return _luma_from_planes(
        image[..., 0].astype(jnp.float32),
        image[..., 1].astype(jnp.float32),
        image[..., 2].astype(jnp.float32),
        normalize,
    )


def subtract_mean(luma: jnp.ndarray, squared: bool = False):
    """Subtract the per-image mean. Returns ``(zero_mean_luma, mean)``.

    Applied to model *inputs only* (never ground truth) — Main_cl.cpp:141,
    230. The mean is returned because write-out needs nothing from it in
    the reference (swap_luma consumes the raw 0..1 net output), but
    callers may want it for diagnostics.

    ``squared=True`` subtracts E[luma²] instead — replicating an upstream
    host bug the shipped reference binary ALWAYS exhibits:
    ``DataPipeline::subtract_mean`` (DataPipeline.cpp:268-280) calls
    ``sum(data, ev_to_wait_for)`` against ``float sum(MemoryHandle,
    bool squared = false, cl_event* = nullptr)`` (DataPipeline.hpp:171),
    so the non-null ``cl_event*`` converts to ``squared=true`` and the
    SUM_SQUARED kernel variant runs. Verified bit-exact against the
    actual binary via tools/reforacle (docs/REFERENCE_PARITY.md); opt in
    with config ``subtract_squared_mean`` when reproducing the binary or
    loading weights it trained.
    """
    mean = jnp.mean(jnp.square(luma) if squared else luma)
    return luma - mean, mean


def swap_luma(
    original_rgb: jnp.ndarray,
    new_luma: jnp.ndarray,
) -> jnp.ndarray:
    """Recombine net-output luma with the original image's chroma.

    ``original_rgb``: uint8 (H, W, C>=3); ``new_luma``: float (lh, lw) in
    0..1. Returns uint8 (H, W, 3). The luma window is centered with
    offset ``(W - lw) // 2`` on BOTH axes (the reference computes the
    padding from the width only — swap_luma.cl:24); border pixels pass
    the original image through (swap_luma.cl:37-42).
    """
    h, w = original_rgb.shape[0], original_rgb.shape[1]
    ro, go, bo, inside = _swap_luma_core(
        original_rgb[..., 0].astype(jnp.float32),
        original_rgb[..., 1].astype(jnp.float32),
        original_rgb[..., 2].astype(jnp.float32),
        new_luma, h, w,
    )
    combined = jnp.stack(
        [b.astype(jnp.uint8) for b in (ro, go, bo)], axis=-1)
    return jnp.where(inside[..., None], combined, original_rgb[..., :3])


def _swap_luma_core(r, g, b, new_luma, h: int, w: int):
    """Shared math of ``swap_luma``/``swap_luma_packed`` on f32 channel
    planes: returns the three output byte planes (uint32 0..255, already
    clamped and truncated) and the inside-window mask."""
    lh, lw = new_luma.shape[0], new_luma.shape[1]
    pad = (w - lw) // 2  # width-derived padding, per the reference

    y_new = jnp.zeros((h, w), dtype=jnp.float32)
    y_new = lax.dynamic_update_slice(y_new, new_luma.astype(jnp.float32), (pad, pad))
    y_new = y_new * 255.0

    cb = r * RGB2CB[0] + g * RGB2CB[1] + b * RGB2CB[2]
    cr = r * RGB2CR[0] + g * RGB2CR[1] + b * RGB2CR[2]
    ro = y_new + cr * YCBCR2R[2]
    go = y_new + cb * YCBCR2G[1] + cr * YCBCR2G[2]
    bo = y_new + cb * YCBCR2B[1]

    def _byte(v):
        # clamp 0..255 then truncate (OpenCL convert_uint rounds toward 0)
        return jnp.trunc(jnp.clip(v, 0.0, 255.0)).astype(jnp.uint32)

    rows = lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (rows >= pad) & (rows < pad + lh) & (cols >= pad) & (cols < pad + lw)
    return _byte(ro), _byte(go), _byte(bo), inside


def extract_luma_packed(rgba_u32: jnp.ndarray, normalize: bool = True) -> jnp.ndarray:
    """``extract_luma`` on byte-packed pixels: (H, W) uint32 (little-endian
    RGBA — byte 0 = R) → float32 luma (H, W).

    Packing each pixel into one uint32 keeps the image a dense 2D array
    and turns the channel extraction into shift/mask ops. Same math as extract_luma (extract_luma.cl:5-21) — bit-identical
    output, pinned by tests.
    """
    r, g, b = unpack_rgb_planes(rgba_u32)
    return _luma_from_planes(r, g, b, normalize)


def swap_luma_packed(rgba_u32: jnp.ndarray, new_luma: jnp.ndarray) -> jnp.ndarray:
    """``swap_luma`` on byte-packed pixels: (H, W) uint32 in, (H, W)
    uint32 out (RGB in bytes 0-2, byte 3 = the original alpha untouched;
    hosts strip it with a free numpy view). Same matrices, clamp,
    truncation, and border-passthrough semantics as ``swap_luma``
    (swap_luma.cl:19-69) — bit-identical RGB bytes, pinned by tests."""
    h, w = rgba_u32.shape
    x = rgba_u32
    r, g, b = unpack_rgb_planes(x)
    ro, go, bo, inside = _swap_luma_core(r, g, b, new_luma, h, w)
    packed = ro | (go << 8) | (bo << 16) | (x & jnp.uint32(0xFF000000))
    return jnp.where(inside, packed, x)


def unpack_rgb_planes(rgba_u32: jnp.ndarray):
    """(.., H, W) uint32 packed pixels → three f32 channel planes
    (R, G, B), 0..255. The device-side unpacker shared by the packed
    color ops; kept separate so full-RGB model paths can build their
    (H, W, 3) net input from dense 2D reads of the packed image."""
    x = rgba_u32
    return ((x & 0xFF).astype(jnp.float32),
            ((x >> 8) & 0xFF).astype(jnp.float32),
            ((x >> 16) & 0xFF).astype(jnp.float32))


def swap_rgb_packed(rgba_u32: jnp.ndarray, new_rgb: jnp.ndarray) -> jnp.ndarray:
    """``swap_rgb`` on byte-packed pixels: (H, W) uint32 in/out (RGB
    replaced inside the centered window, byte 3 = original alpha
    untouched). Same clamp/truncation/border semantics as ``swap_rgb``
    — bit-identical RGB bytes, pinned by tests."""
    h, w = rgba_u32.shape
    lh, lw = new_rgb.shape[0], new_rgb.shape[1]
    pad = (w - lw) // 2
    x = rgba_u32

    def _byte_plane(c):
        v = jnp.trunc(jnp.clip(new_rgb[..., c] * 255.0, 0.0, 255.0)).astype(jnp.uint32)
        full = jnp.zeros((h, w), jnp.uint32)
        return lax.dynamic_update_slice(full, v, (pad, pad))

    packed = (_byte_plane(0) | (_byte_plane(1) << 8) | (_byte_plane(2) << 16)
              | (x & jnp.uint32(0xFF000000)))
    rows = lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (rows >= pad) & (rows < pad + lh) & (cols >= pad) & (cols < pad + lw)
    return jnp.where(inside, packed, x)


def pack_rgba_host(image: "np.ndarray") -> "np.ndarray":
    """Host-side (numpy) packer: uint8 (..., H, W, 3|4) → (..., H, W)
    uint32 little-endian RGBA (alpha filled with 255 for 3-channel
    input). A free view for contiguous RGBA input; one memcpy
    otherwise."""
    import numpy as np

    if image.dtype != np.uint8 or image.ndim < 3 or image.shape[-1] not in (3, 4):
        raise ValueError(f"expected uint8 (..., H, W, 3|4), got {image.dtype} {image.shape}")
    if image.shape[-1] == 3:
        image = np.concatenate(
            [image, np.full(image.shape[:-1] + (1,), 255, np.uint8)], axis=-1)
    image = np.ascontiguousarray(image)
    return image.view(np.uint32)[..., 0]


def unpack_rgb_host(packed: "np.ndarray") -> "np.ndarray":
    """Host-side inverse for outputs: (H, W) uint32 → uint8 (H, W, 3)
    (drops the alpha byte; a numpy view + slice)."""
    import numpy as np

    return packed.view(np.uint8).reshape(packed.shape + (4,))[..., :3]


def swap_rgb(original_rgb: jnp.ndarray, new_rgb: jnp.ndarray) -> jnp.ndarray:
    """Full-RGB variant of ``swap_luma`` for 3-channel models: paste the
    net's 0..1 RGB output (lh, lw, 3) into the center of the original
    image, truncating to uint8; border passes through."""
    h, w = original_rgb.shape[0], original_rgb.shape[1]
    lh, lw = new_rgb.shape[0], new_rgb.shape[1]
    pad = (w - lw) // 2

    out = jnp.trunc(jnp.clip(new_rgb * 255.0, 0.0, 255.0)).astype(jnp.uint8)
    canvas = original_rgb[..., :3]
    canvas = lax.dynamic_update_slice(canvas, out, (pad, pad, 0))
    return canvas
