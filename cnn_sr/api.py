"""High-level inference API: one fused jitted program per image shape.

The reference's forward/upscale path (execute_forward, Main_cl.cpp:217-241;
write_result_image, ConfigBasedDataPipeline.cpp:499-528) crosses the
device boundary several times (image upload, 1-float mean readback, final
readback). Here the whole pipeline — luma extract → mean subtract →
N-layer conv → swap-luma recombine — is ONE ``jax.jit`` program: the
uint8 image goes to HBM once and uint8 RGB comes back once; XLA fuses the
elementwise color math into the conv prologue/epilogue.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .models import forward
from .ops.color import (
    extract_luma,
    extract_luma_packed,
    pack_rgba_host,
    subtract_mean,
    swap_luma,
    swap_luma_packed,
    swap_rgb,
    swap_rgb_packed,
    unpack_rgb_host,
    unpack_rgb_planes,
)
from .utils.cache import LRUCache
from .utils.config import Config


@partial(jax.jit, static_argnames=("add_mean", "squared_mean"))
def _upscale_luma_jit(params, rgba, add_mean: bool = False,
                      squared_mean: bool = False):
    """uint8 RGBA (H, W, 4) → uint8 RGB (H, W, 3), luma-channel model.
    ``add_mean``: the model predicts mean-relative luma
    (config ``zero_mean_target``) — add the input mean back.
    The convs run at ``Precision.HIGHEST`` (true f32; a float32 conv on
    the GPU would otherwise run in TF32)."""
    luma = extract_luma(rgba, normalize=True)
    luma0, mean = subtract_mean(luma, squared=squared_mean)
    y = forward(params, luma0[None, ..., None])[0, ..., 0]
    if add_mean:
        y = y + mean
    return swap_luma(rgba, y)


@partial(jax.jit, static_argnames=("add_mean", "squared_mean"))
def _upscale_luma_packed_jit(params, rgba_u32, add_mean: bool = False,
                             squared_mean: bool = False):
    """Byte-packed twin of ``_upscale_luma_jit``: (H, W) uint32 RGBA in,
    (H, W) uint32 RGB(A) out. The packed form keeps the image dense 2D
    and turns channel access into shift/mask ops. Bit-identical output
    (ops.color shares one expression core between the two forms; pinned
    by tests)."""
    luma = extract_luma_packed(rgba_u32, normalize=True)
    luma0, mean = subtract_mean(luma, squared=squared_mean)
    y = forward(params, luma0[None, ..., None])[0, ..., 0]
    if add_mean:
        y = y + mean
    return swap_luma_packed(rgba_u32, y)


@partial(jax.jit, static_argnames="add_mean")
def _upscale_rgb_jit(params, rgba, add_mean: bool = False):
    """uint8 RGBA (H, W, 4) → uint8 RGB (H, W, 3), full-RGB model
    (extended waifu2x-style variant)."""
    rgb = rgba[..., :3].astype(jnp.float32) / 255.0
    # per-channel mean subtraction on the *input* only; like the luma
    # path, the net is trained against raw 0..1 targets and outputs
    # absolute intensities (samples.load_sample_set uses the same rule)
    # unless the config opts into mean-relative targets (add_mean)
    mean = jnp.mean(rgb, axis=(0, 1), keepdims=True)
    y = forward(params, (rgb - mean)[None])[0]
    if add_mean:
        y = y + mean
    return swap_rgb(rgba, y)


@partial(jax.jit, static_argnames="add_mean")
def _upscale_rgb_packed_jit(params, rgba_u32, add_mean: bool = False):
    """Byte-packed twin of ``_upscale_rgb_jit``: (H, W) uint32 in/out.
    The net still consumes a (H, W, 3) f32 array (that layout is the
    conv input either way), but the uint8 image reads and the final
    image write stay dense 2D."""
    r, g, b = unpack_rgb_planes(rgba_u32)
    rgb = jnp.stack([r, g, b], axis=-1) / 255.0
    mean = jnp.mean(rgb, axis=(0, 1), keepdims=True)
    y = forward(params, (rgb - mean)[None])[0]
    if add_mean:
        y = y + mean
    return swap_rgb_packed(rgba_u32, y)


@partial(jax.jit, static_argnames=("add_mean", "squared_mean"))
def _luma_forward_padded(params, rgba_padded, valid_h, valid_w,
                         add_mean: bool = False, squared_mean: bool = False):
    """Net luma output for an edge-padded image whose valid region is
    (valid_h, valid_w) — traced scalars, so ONE compiled program serves
    every image that rounds up to the same bucket shape.

    Valid-conv outputs inside the valid region read only valid input
    pixels, so they equal the unpadded computation exactly — provided the
    mean subtraction uses the valid-region mean (masked sum here).
    """
    luma = extract_luma(rgba_padded, normalize=True)
    h, w = luma.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    valid = (rows < valid_h) & (cols < valid_w)
    stat = jnp.square(luma) if squared_mean else luma
    mean = jnp.sum(jnp.where(valid, stat, 0.0)) / (
        valid_h.astype(jnp.float32) * valid_w.astype(jnp.float32)
    )
    luma0 = luma - mean
    y = forward(params, luma0[None, ..., None])[0, ..., 0]
    return y + mean if add_mean else y


@jax.jit
def _swap_luma_jit(rgba, y):
    return swap_luma(rgba, y)


@partial(jax.jit, static_argnames="add_mean")
def _rgb_forward_padded(params, rgba_padded, valid_h, valid_w,
                        add_mean: bool = False):
    """RGB-model analog of ``_luma_forward_padded``: per-channel
    valid-region mean subtraction on an edge-padded image."""
    rgb = rgba_padded[..., :3].astype(jnp.float32) / 255.0
    h, w = rgb.shape[0], rgb.shape[1]
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    valid = ((rows < valid_h) & (cols < valid_w))[..., None]
    count = valid_h.astype(jnp.float32) * valid_w.astype(jnp.float32)
    mean = jnp.sum(jnp.where(valid, rgb, 0.0), axis=(0, 1), keepdims=True) / count
    y = forward(params, (rgb - mean)[None])[0]
    return y + mean if add_mean else y


@jax.jit
def _swap_rgb_jit(rgba, y):
    return swap_rgb(rgba, y)


def _upscale_rgb_bucketed(cfg, params, rgba, bucket: int):
    h, w = rgba.shape[:2]
    shrink = cfg.total_padding()
    hp = -(-h // bucket) * bucket
    wp = -(-w // bucket) * bucket
    padded = np.pad(rgba, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    y = _rgb_forward_padded(
        params, jnp.asarray(padded), jnp.int32(h), jnp.int32(w),
        add_mean=cfg.zero_mean_target,
    )
    y_valid = y[: h - shrink, : w - shrink]
    return np.asarray(_swap_rgb_jit(jnp.asarray(rgba), y_valid))


def _upscale_luma_bucketed(cfg, params, rgba, bucket: int):
    """Pad H/W up to multiples of ``bucket`` (edge replication) so the
    expensive conv program compiles once per bucket instead of once per
    image shape; only the cheap swap-luma program is shape-specific."""
    h, w = rgba.shape[:2]
    shrink = cfg.total_padding()
    hp = -(-h // bucket) * bucket
    wp = -(-w // bucket) * bucket
    padded = np.pad(rgba, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    y = _luma_forward_padded(
        params, jnp.asarray(padded),
        jnp.int32(h), jnp.int32(w), add_mean=cfg.zero_mean_target,
        squared_mean=cfg.subtract_squared_mean,
    )
    y_valid = y[: h - shrink, : w - shrink]
    return np.asarray(_swap_luma_jit(jnp.asarray(rgba), y_valid))


def upscale_image(
    cfg: Config,
    params,
    rgba: np.ndarray,
    bucket: int = 0,
    packed_io: bool = False,
) -> np.ndarray:
    """Run the network over a decoded uint8 RGBA image; returns uint8 RGB.

    The luma model replaces the Y channel inside the valid-conv center
    window and passes the border through (reference behavior); the RGB
    model does the same with all three channels.

    ``bucket`` > 0 pads image shapes up to multiples of ``bucket`` so the
    conv program compiles once per bucket instead of once per exact image
    size (results are identical; recommended 64 when processing many
    differently-sized images).

    ``packed_io``: run the pipeline's color ends on uint32 byte-packed
    pixels (a dense 2D image instead of a rank-3 one; bit-identical
    output). Unbucketed path only; ignored with ``bucket``.
    """
    shrink = cfg.total_padding()
    if rgba.shape[0] <= shrink or rgba.shape[1] <= shrink:
        raise ValueError(
            f"image {rgba.shape[1]}x{rgba.shape[0]} is not larger than the "
            f"model's receptive field ({shrink}+1 px per side)")
    params_j = jax.tree.map(jnp.asarray, params)
    if bucket > 0:
        if cfg.channels == 1:
            return _upscale_luma_bucketed(cfg, params_j, np.asarray(rgba),
                                          bucket)
        return _upscale_rgb_bucketed(cfg, params_j, np.asarray(rgba), bucket)
    if packed_io:
        packed = jnp.asarray(pack_rgba_host(np.asarray(rgba)))
        if cfg.channels == 1:
            out_u32 = _upscale_luma_packed_jit(
                params_j, packed, add_mean=cfg.zero_mean_target,
                squared_mean=cfg.subtract_squared_mean)
        else:
            out_u32 = _upscale_rgb_packed_jit(
                params_j, packed, add_mean=cfg.zero_mean_target)
        return np.ascontiguousarray(unpack_rgb_host(np.asarray(out_u32)))
    img = jnp.asarray(rgba)
    if cfg.channels == 1:
        out = _upscale_luma_jit(params_j, img, add_mean=cfg.zero_mean_target,
                                squared_mean=cfg.subtract_squared_mean)
    else:
        out = _upscale_rgb_jit(params_j, img, add_mean=cfg.zero_mean_target)
    return np.asarray(out)


@partial(jax.jit, static_argnames=("add_mean", "squared_mean"))
def _upscale_luma_batch_jit(params, rgbas, add_mean: bool = False,
                            squared_mean: bool = False):
    """uint8 RGBA (S, H, W, 4) → uint8 RGB (S, H, W, 3) — batched luma
    pipeline in one program (the batch axis also shards over a "data"
    mesh axis under jit, giving multi-chip batched inference for free)."""
    lumas = jax.vmap(lambda im: extract_luma(im, normalize=True))(rgbas)
    means = jnp.mean(jnp.square(lumas) if squared_mean else lumas,
                     axis=(1, 2), keepdims=True)
    lumas0 = lumas - means
    ys = forward(params, lumas0[..., None])[..., 0]
    if add_mean:
        ys = ys + means
    return jax.vmap(swap_luma)(rgbas, ys)


@partial(jax.jit, static_argnames=("add_mean", "squared_mean"))
def _upscale_luma_batch_packed_jit(params, rgbas_u32, add_mean: bool = False,
                                   squared_mean: bool = False):
    """Byte-packed twin of ``_upscale_luma_batch_jit``: (S, H, W) uint32
    in/out (see ``_upscale_luma_packed_jit``)."""
    lumas = jax.vmap(lambda im: extract_luma_packed(im, normalize=True))(rgbas_u32)
    means = jnp.mean(jnp.square(lumas) if squared_mean else lumas,
                     axis=(1, 2), keepdims=True)
    lumas0 = lumas - means
    ys = forward(params, lumas0[..., None])[..., 0]
    if add_mean:
        ys = ys + means
    return jax.vmap(swap_luma_packed)(rgbas_u32, ys)


@partial(jax.jit, static_argnames="add_mean")
def _upscale_rgb_batch_jit(params, rgbas, add_mean: bool = False):
    """uint8 RGBA (S, H, W, 4) → uint8 RGB (S, H, W, 3) — batched RGB
    pipeline in ONE dispatch (a per-image Python loop would buy the
    batching queue nothing for the 7-layer RGB family, where
    per-dispatch overhead matters most; reference analog: the batched
    sample_id NDRange axis, layer_uber_kernel.cl:45). ``forward``
    already takes (N, H, W, C); the color ends vmap."""
    rgbs = rgbas[..., :3].astype(jnp.float32) / 255.0
    means = jnp.mean(rgbs, axis=(1, 2), keepdims=True)  # per image+channel
    xs = rgbs - means
    ys = forward(params, xs)
    if add_mean:
        ys = ys + means
    return jax.vmap(swap_rgb)(rgbas, ys)


@partial(jax.jit, static_argnames="add_mean")
def _upscale_rgb_batch_packed_jit(params, rgbas_u32, add_mean: bool = False):
    """Byte-packed twin of ``_upscale_rgb_batch_jit``: (S, H, W) uint32
    in/out (see ``_upscale_luma_packed_jit``)."""
    def _unpack(u32):
        r, g, b = unpack_rgb_planes(u32)
        return jnp.stack([r, g, b], axis=-1) / 255.0

    rgbs = jax.vmap(_unpack)(rgbas_u32)
    means = jnp.mean(rgbs, axis=(1, 2), keepdims=True)
    xs = rgbs - means
    ys = forward(params, xs)
    if add_mean:
        ys = ys + means
    return jax.vmap(swap_rgb_packed)(rgbas_u32, ys)


def upscale_batch(
    cfg: Config,
    params,
    rgbas: np.ndarray,
    packed_io: bool = False,
) -> np.ndarray:
    """Batched upscaling of same-sized images (S, H, W, 4) → (S, H, W, 3).

    ``packed_io``: byte-packed color ends (bit-identical output) — see
    ``upscale_image``."""
    shrink = cfg.total_padding()
    if rgbas.shape[1] <= shrink or rgbas.shape[2] <= shrink:
        raise ValueError(
            f"images {rgbas.shape[2]}x{rgbas.shape[1]} are not larger than "
            f"the model's receptive field ({shrink}+1 px per side)")
    params_j = jax.tree.map(jnp.asarray, params)
    if packed_io:
        packed = jnp.asarray(pack_rgba_host(np.asarray(rgbas)))
        if cfg.channels == 1:
            out_u32 = _upscale_luma_batch_packed_jit(
                params_j, packed, add_mean=cfg.zero_mean_target,
                squared_mean=cfg.subtract_squared_mean)
        else:
            out_u32 = _upscale_rgb_batch_packed_jit(
                params_j, packed, add_mean=cfg.zero_mean_target)
        return np.ascontiguousarray(unpack_rgb_host(np.asarray(out_u32)))
    imgs = jnp.asarray(rgbas)
    if cfg.channels == 1:
        out = _upscale_luma_batch_jit(params_j, imgs, add_mean=cfg.zero_mean_target,
                                      squared_mean=cfg.subtract_squared_mean)
    else:
        out = _upscale_rgb_batch_jit(params_j, imgs, add_mean=cfg.zero_mean_target)
    return np.asarray(out)


# bounded LRU: spatial serving programs per (shards, channels, flags)
# combination — eviction keeps long-lived serve processes flat (the key
# also pins the Mesh alive, so unbounded growth would leak meshes too)
_SPATIAL_STEPS = LRUCache(maxsize=8)


def upscale_image_spatial(
    cfg: Config,
    params,
    rgba: np.ndarray,
    n_shards: int,
) -> np.ndarray:
    """Single-image upscaling with the image's rows sharded over
    ``n_shards`` devices — halo-exchange spatial parallelism
    (``parallel.spatial.sharded_forward``): each device computes its row
    band after ONE neighbor ``ppermute`` of the stack's receptive-field
    halo. Results are identical to the single-device path (the
    image is bottom-padded to a multiple of ``n_shards`` and the padded
    rows' outputs are cropped before the luma/RGB swap).

    This is the image-domain analog of sequence/context parallelism: it
    lets one image larger than a single chip's comfortable working set
    (or a latency-critical frame) span the mesh. ``n_shards`` must not
    exceed ``len(jax.devices())``.
    """
    from .parallel.mesh import make_mesh
    from .parallel.spatial import sharded_forward

    if n_shards > len(jax.devices()):
        raise ValueError(
            f"--spatial-shard {n_shards} > {len(jax.devices())} devices")
    params_j = jax.tree.map(jnp.asarray, params)
    shrink = cfg.total_padding()
    mesh = make_mesh(n_data=1, n_spatial=n_shards,
                     devices=jax.devices()[:n_shards])

    key = (n_shards, cfg.channels, cfg.zero_mean_target,
           cfg.subtract_squared_mean)
    step = _SPATIAL_STEPS.get(key)
    if step is None:

        @partial(jax.jit, static_argnames=("pad_rows",))
        def step(params, rgba, pad_rows, _mesh=mesh):
            if cfg.channels == 1:
                luma = extract_luma(rgba, normalize=True)
                plane0, mean = subtract_mean(
                    luma, squared=cfg.subtract_squared_mean)
                x = plane0[None, ..., None]
            else:
                rgb = rgba[..., :3].astype(jnp.float32) / 255.0
                mean = jnp.mean(rgb, axis=(0, 1), keepdims=True)
                x = (rgb - mean)[None]
            # bottom-pad rows to a multiple of the spatial axis; padded
            # rows only feed outputs past the valid region (cropped)
            x = jnp.pad(x, ((0, 0), (0, pad_rows), (0, 0), (0, 0)))
            y = sharded_forward(_mesh, params, x)
            return y, mean

        _SPATIAL_STEPS[key] = step

    h, w = rgba.shape[0], rgba.shape[1]
    if (h - shrink) <= 0 or (w - shrink) <= 0:
        raise ValueError(f"image {w}x{h} smaller than the receptive field")
    pad_rows = (-h) % n_shards
    shard_rows = (h + pad_rows) // n_shards
    if shard_rows < shrink:
        raise ValueError(
            f"shard height {shard_rows} < receptive-field shrink {shrink}; "
            f"use fewer shards for this image")
    y, mean = step(params_j, jnp.asarray(rgba), pad_rows)
    y = y[:, : h - shrink, : w - shrink]
    if cfg.zero_mean_target:
        y = y + mean
    if cfg.channels == 1:
        out = _swap_luma_jit(jnp.asarray(rgba), y[0, ..., 0])
    else:
        out = _swap_rgb_jit(jnp.asarray(rgba), y[0])
    return np.asarray(out)
