#!/usr/bin/env python
"""Training grad-step formulation A/B.

Times the grad step of three formulations at both training precisions:

* ``conv``   — the incumbent: ``jax.grad(models.loss_sum)`` through
  ``lax.conv_general_dilated`` (HIGHEST for parity, bf16 mixed for
  throughput);
* ``im2col`` — full-patch matmuls ``(M, f²k) @ (f²k, n)`` per layer,
  autodiff'd (the VJP scatters into the patch slices);
* ``sep``    — per-dy banded matmuls ``(M, f·k) @ (f·k, n)`` summed
  over dy (the inference sep formulation, autodiff'd).

All three share the exact loss structure (0.5·Σd², ReLU' gate,
center crop) so gradients agree to precision; the probe asserts
cross-formulation gradient agreement before timing. Timing is the
two-length chained-scan marginal: each scan iteration applies a tiny
dependent update so pipelined dispatch can't hide compute.

Workloads: the reference profile.py 36×128² set on 9-1-5 and 9-5-5.
Run it alone on the device:

    python tools/train_formulations_probe.py
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--iters", type=int, default=24,
                   help="long scan length (short = iters//3)")
    p.add_argument("--samples", type=int, default=36)
    p.add_argument("--size", type=int, default=128)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from jax import lax

    from cnn_sr.models import forward
    from cnn_sr.models.srcnn import center_crop, relu_backprop_gate

    rng = np.random.default_rng(0)

    def mk_params(spec):
        return [
            {"w": jnp.asarray(
                rng.standard_normal((f, f, k, n)).astype(np.float32) * 0.05),
             "b": jnp.asarray(
                 rng.standard_normal(n).astype(np.float32) * 0.01)}
            for f, k, n in spec
        ]

    def conv_fwd(params, x, precision):
        return forward(params, x, precision=precision)

    def _mm(patches, w2, precision):
        return lax.dot_general(
            patches, w2, (((3,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=precision)

    def im2col_fwd(params, x, precision):
        n_layers = len(params)
        y = x
        for i, layer in enumerate(params):
            w, b = layer["w"], layer["b"]
            f, _, k, n = w.shape
            oh, ow = y.shape[1] - f + 1, y.shape[2] - f + 1
            cols = [y[:, dy:dy + oh, dx:dx + ow, :]
                    for dy in range(f) for dx in range(f)]
            y = _mm(jnp.concatenate(cols, axis=-1),
                    w.reshape(f * f * k, n).astype(y.dtype), precision)
            y = y + b
            if i != n_layers - 1:
                y = jnp.maximum(y, 0.0)
        return y

    def sep_fwd(params, x, precision):
        n_layers = len(params)
        y = x
        for i, layer in enumerate(params):
            w, b = layer["w"], layer["b"]
            f, _, k, n = w.shape
            oh, ow = y.shape[1] - f + 1, y.shape[2] - f + 1
            acc = None
            for dy in range(f):
                band = y[:, dy:dy + oh]
                patches = jnp.concatenate(
                    [band[:, :, dx:dx + ow, :] for dx in range(f)], axis=-1)
                part = _mm(patches, w[dy].reshape(f * k, n).astype(y.dtype),
                           precision)
                acc = part if acc is None else acc + part
            y = acc + b
            if i != n_layers - 1:
                y = jnp.maximum(y, 0.0)
        return y

    def make_loss(fwd, mixed):
        def loss(params, x, t):
            if mixed:
                params = jax.tree.map(
                    lambda a: a.astype(jnp.bfloat16), params)
                x = x.astype(jnp.bfloat16)
                y = fwd(params, x, lax.Precision.DEFAULT)
                y = y.astype(jnp.float32)
            else:
                y = fwd(params, x, lax.Precision.HIGHEST)
            y = relu_backprop_gate(y)
            d = y - center_crop(t, y.shape[-3], y.shape[-2])
            return 0.5 * jnp.sum(d * d)
        return loss

    def make_chained(loss):
        @functools.partial(jax.jit, static_argnames=("n",))
        def chained(params, x, t, n):
            def body(pc, _):
                g = jax.grad(loss)(pc, x, t)
                # tiny dependent update: real data dependency between
                # iterations so pipelined dispatch can't hide compute
                p2 = jax.tree.map(lambda a, b: a - 1e-12 * b, pc, g)
                return p2, ()
            return lax.scan(body, params, None, length=n)[0]
        return chained

    FWD = {"conv": conv_fwd, "im2col": im2col_fwd, "sep": sep_fwd}

    for name, spec in (("9-1-5", ((9, 1, 64), (1, 64, 32), (5, 32, 1))),
                       ("9-5-5", ((9, 1, 64), (5, 64, 32), (5, 32, 1)))):
        params = mk_params(spec)
        x = jnp.asarray(rng.random(
            (args.samples, args.size, args.size, 1), np.float32))
        t = jnp.asarray(rng.random(
            (args.samples, args.size, args.size, 1), np.float32))

        # cross-formulation gradient agreement (f32 HIGHEST)
        g0 = jax.grad(make_loss(conv_fwd, False))(params, x, t)
        for fname in ("im2col", "sep"):
            g1 = jax.grad(make_loss(FWD[fname], False))(params, x, t)
            rel = max(
                float(jnp.max(jnp.abs(a["w"] - b["w"]))
                      / (1e-30 + jnp.max(jnp.abs(a["w"]))))
                for a, b in zip(g0, g1))
            print(f"{name} {fname}: max rel grad diff vs conv = {rel:.2e}")
            assert rel < 1e-3, (name, fname, rel)

        short, long_ = max(1, args.iters // 3), args.iters
        for mixed in (False, True):
            tag = "bf16" if mixed else "f32-HIGHEST"
            fns = {fname: make_chained(make_loss(fwd, mixed))
                   for fname, fwd in FWD.items()}

            def run(fn, n):
                t0 = time.perf_counter()
                out = fn(params, x, t, n)
                _ = float(np.asarray(out[0]["b"][0]))
                return time.perf_counter() - t0

            for fn in fns.values():  # compile both lengths
                run(fn, short), run(fn, long_)
            results = {k: [] for k in fns}
            for r in range(args.rounds):
                for fname, fn in fns.items():
                    ts_ = run(fn, short)
                    tl = run(fn, long_)
                    results[fname].append(
                        (tl - ts_) / (long_ - short) * 1e3)
            for fname, ms in results.items():
                print(f"{name} {tag:12s} {fname:7s}: best "
                      f"{min(ms):7.2f} ms/grad-step  (all: "
                      + ", ".join(f"{m:.2f}" for m in ms) + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
