"""The generic layer-list SRCNN model family, as pure jittable functions.

The JAX equivalent of the reference's forward/backward compute path:

* forward: the reference JIT-compiles one OpenCL "uber kernel" per layer
  computing a VALID, stride-1 **cross-correlation** + bias + ReLU (linear
  on the last layer — SKIP_RELU) with weights laid out ``[f,f,k,n]``,
  n fastest (layer_uber_kernel.cl:3-12,59-95; ConfigBasedDataPipeline.cpp:54-75,
  200-241). Here each layer is one ``lax.conv_general_dilated`` in
  NHWC/HWIO — XLA hands it to the device's convolution library (cuDNN
  on a GPU) and fuses bias+ReLU.

* backward: the reference hand-derives per-layer delta and gradient
  kernels (layer_deltas.cl, last_layer_delta.cl, backpropagate.cl). We do
  NOT port those — ``jax.grad`` of ``loss_sum`` reproduces exactly the
  same math (the hand-written kernels serve as numpy test oracles in
  ``tests/oracles.py``), including the reference's quirk of applying a
  ReLU' factor to the *last, linear* layer's delta
  (last_layer_delta.cl:42-47 vs the SKIP_RELU forward,
  ConfigBasedDataPipeline.cpp:66): ``relu_backprop_gate`` is an identity
  in the forward pass whose VJP multiplies by ``(y > 0)``, which makes
  ``jax.grad`` emit the identical gradient.

All functions take ``params``: a list of ``{"w": (f,f,k,n), "b": (n,)}``
pytrees (see utils/params_io.py) and NHWC image tensors.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import jax
import jax.numpy as jnp
from jax import lax

Params = Sequence[dict]

_DIMENSION_NUMBERS = ("NHWC", "HWIO", "NHWC")


@jax.custom_vjp
def relu_backprop_gate(y: jnp.ndarray) -> jnp.ndarray:
    """Identity with a ReLU' VJP: forward returns ``y`` unchanged, the
    backward pass multiplies the cotangent by ``(y > 0)``.

    Replicates the reference's last-layer-delta quirk: layer 3 is linear
    (SKIP_RELU — ConfigBasedDataPipeline.cpp:66) yet its delta is
    ``(y - t) · relu'(y)`` (last_layer_delta.cl:42-47). Wrapping the
    final layer output with this gate before the loss makes ``jax.grad``
    reproduce that exact gradient.
    """
    return y


def _gate_fwd(y):
    return y, (y > 0).astype(y.dtype)


def _gate_bwd(mask, g):
    return (g * mask,)


relu_backprop_gate.defvjp(_gate_fwd, _gate_bwd)


def conv_layer(
    x: jnp.ndarray,
    w: jnp.ndarray,
    b: jnp.ndarray,
    relu: bool,
    precision=lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """One SRCNN layer: VALID stride-1 cross-correlation + bias (+ ReLU).

    ``x``: (N, H, W, K) activations; ``w``: (f, f, K, n) HWIO weights
    (= the reference's flat ``[f,f,k,n]`` n-fastest layout,
    layer_uber_kernel.cl:3-12); ``b``: (n,).

    ``precision`` defaults to HIGHEST, true f32: at DEFAULT a GPU runs
    f32 convs in TF32 (10-bit mantissa) and an accelerator with a bf16
    matrix unit in bf16 passes, either of which breaks gradient parity
    with the reference's f32 math.
    """
    y = lax.conv_general_dilated(
        x,
        w,
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=_DIMENSION_NUMBERS,
        preferred_element_type=x.dtype,
        precision=precision,
    )
    y = y + b
    if relu:
        y = jnp.maximum(y, 0.0)
    return y


def forward(params: Params, x: jnp.ndarray,
            precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """Full forward pass: ReLU on every layer but the last (linear), as in
    ConfigBasedDataPipeline::forward (ConfigBasedDataPipeline.cpp:200-241).

    ``x``: (N, H, W, C) — C=1 luma (reference) or C=3 RGB (extended).
    Output spatial dims shrink by ``sum(f_i - 1)`` (valid convs).
    """
    y = x
    last = len(params) - 1
    for i, layer in enumerate(params):
        y = conv_layer(y, layer["w"], layer["b"], relu=(i != last),
                       precision=precision)
    return y


def forward_activations(params: Params, x: jnp.ndarray) -> List[jnp.ndarray]:
    """Forward pass returning every layer's output (for tests/debugging,
    mirroring the reference's per-layer GPU buffers)."""
    acts = []
    y = x
    last = len(params) - 1
    for i, layer in enumerate(params):
        y = conv_layer(y, layer["w"], layer["b"], relu=(i != last))
        acts.append(y)
    return acts


def center_crop(gt: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Crop ground truth to the net output size with the symmetric padding
    offset ``(gt_w - out_w) // 2`` (last_layer_delta.cl:30-36,
    squared_error.cl:57-61)."""
    pad_h = (gt.shape[-3] - out_h) // 2
    pad_w = (gt.shape[-2] - out_w) // 2
    return gt[..., pad_h : pad_h + out_h, pad_w : pad_w + out_w, :]


def loss_sum(params: Params, x: jnp.ndarray, gt: jnp.ndarray,
             precision=lax.Precision.HIGHEST,
             relu_gate: bool = True,
             compute_dtype=None) -> jnp.ndarray:
    """Training loss whose gradient matches the reference's backprop:
    ``0.5 · Σ (y − crop(gt))²`` summed over pixels, channels AND samples.

    The 0.5 makes ``dL/dy = (y − t)`` exactly as last_layer_delta.cl:40-47
    (the reference's gradient buffers accumulate raw sums across the whole
    train set — ConfigBasedDataPipeline.cpp:128-195, 325-361 — and the
    batch-size division happens inside the update rule, so this loss is
    intentionally NOT mean-reduced). Includes the ReLU' backprop gate.

    ``relu_gate=False`` (config ``last_layer_relu_gate``) drops the
    reference's last-layer ReLU' quirk: the gate zeroes gradients
    wherever the linear output is ≤ 0, which freezes every pixel whose
    target is negative — survivable with the reference's 0..1 absolute
    targets, fatal with ``zero_mean_target``'s signed ones.

    ``compute_dtype`` (e.g. ``jnp.bfloat16``) opts into mixed-precision
    training: parameters and activations are cast to it for the forward
    AND the backprop through it (``precision`` is ignored — the matrix
    units run native passes on the narrow dtype), while the loss
    difference, the loss sum, and the gradients that reach the f32
    master parameters (via the cast's VJP) stay float32 — the standard
    master-weights mixed-precision scheme, opting out of the
    reference's all-f32 OpenCL math for throughput.
    """
    if compute_dtype is not None:
        params = jax.tree.map(lambda a: a.astype(compute_dtype), params)
        x = x.astype(compute_dtype)
        # plain XLA convs: the im2col matmul formulation
        # (models.fast_forward) differentiates into slice-scatter adds
        y = forward(params, x, precision=lax.Precision.DEFAULT)
        y = y.astype(jnp.float32)
    else:
        y = forward(params, x, precision=precision)
    if relu_gate:
        y = relu_backprop_gate(y)
    t = center_crop(gt, y.shape[-3], y.shape[-2])
    d = y - t
    return 0.5 * jnp.sum(d * d)


def squared_error_sum(y: jnp.ndarray, gt: jnp.ndarray) -> jnp.ndarray:
    """Validation metric: total Σ (y − crop(gt))² over pixels and samples,
    as computed by squared_error.cl:63-91 (the caller divides by the
    validation-set size for the printed 'mean validation error',
    Main_cl.cpp:186-191)."""
    t = center_crop(gt, y.shape[-3], y.shape[-2])
    d = y - t
    return jnp.sum(d * d)


def luma_mse_metrics(params: Params, x: jnp.ndarray, gt: jnp.ndarray) -> jnp.ndarray:
    """Fused forward + squared-error for validation batches."""
    y = forward(params, x)
    return squared_error_sum(y, gt)
