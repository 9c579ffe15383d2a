"""Inference forward in plain XLA as im2col matmuls.

The same math as ``models.forward`` expressed as dense matmuls:

* **first layer (C_in = 1)**: concatenate the f² shifted copies of the
  luma plane along channels → one ``(M, f²) @ (f², n₁)`` matmul;
* **middle layers**: per-dy im2col — concatenate the f column-shifted
  channel blocks of a row band → ``(M, f·k) @ (f·k, n)`` accumulated
  over dy (K = 320 for 9-5-5's layer 2);
* **last layer (n_out small)**: same per-dy patches; the tiny-N matmul
  is fine here because K is large and M streams.

Patches materialize in device memory (≈ f× the activation bytes). It is
kept beside the conv formulation until the GPU measurement decides
which one each cell prefers (chip_smoke.py phase c times both).

``dtype`` controls the streaming precision: ``bfloat16`` (default) runs
the matmuls on bf16 operands with f32 accumulation
(``preferred_element_type``); ``float32`` gives exact parity with
``models.forward`` for validation. bf16's output error on 0..1 luma is
~1e-3 RMS, gated by tests.

This is the *inference* path; training keeps the autodiff-friendly
``models.forward`` (same math, HIGHEST precision).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _conv_first(x, w, b, relu, dtype):
    """(N, H, W, k) → (N, H−f+1, W−f+1, n) via full-f²·k im2col
    (intended for small k — the 1-channel luma or 3-channel RGB input)."""
    f, _, k, n = w.shape
    oh = x.shape[1] - f + 1
    ow = x.shape[2] - f + 1
    cols = [
        x[:, dy : dy + oh, dx : dx + ow, :]
        for dy in range(f)
        for dx in range(f)
    ]
    patches = jnp.concatenate(cols, axis=-1).astype(dtype)  # (N, oh, ow, f²·k)
    y = jax.lax.dot_general(
        patches,
        w.reshape(f * f * k, n).astype(dtype),
        (((3,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    y = y + b
    if relu:
        y = jnp.maximum(y, 0.0)
    return y


def _conv_mid(a, w, b, relu, dtype):
    """(N, H, W, k) → (N, H−f+1, W−f+1, n) via per-dy im2col matmuls."""
    f, _, k, n = w.shape
    oh = a.shape[1] - f + 1
    ow = a.shape[2] - f + 1
    a = a.astype(dtype)
    wd = w.astype(dtype)
    y = None
    for dy in range(f):
        band = a[:, dy : dy + oh]
        patches = jnp.concatenate(
            [band[:, :, dx : dx + ow, :] for dx in range(f)], axis=-1
        )  # (N, oh, ow, f·k)
        part = jax.lax.dot_general(
            patches,
            wd[dy].reshape(f * k, n),
            (((3,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        y = part if y is None else y + part
    y = y + b
    if relu:
        y = jnp.maximum(y, 0.0)
    return y


def fast_forward(params, x, dtype=jnp.bfloat16):
    """Drop-in for ``models.forward`` (NHWC in/out, f32 output), built
    from im2col matmuls. ``dtype``: streaming precision of patches and
    weights (accumulation is always f32)."""
    n_layers = len(params)
    y = x
    for i, layer in enumerate(params):
        w, b = layer["w"], layer["b"]
        relu = i != n_layers - 1
        if i == 0 and w.shape[2] <= 4:
            y = _conv_first(y, w, b, relu, dtype)
        else:
            y = _conv_mid(y, w, b, relu, dtype)
        if relu and i + 1 < n_layers:
            # keep activations in streaming dtype between layers
            y = y.astype(dtype)
    return y.astype(jnp.float32)
