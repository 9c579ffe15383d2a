"""cnn_sr — an SRCNN super-resolution framework in JAX/XLA.

A from-scratch rebuild of the capabilities of the reference OpenCL/C++
application (Scthe/cnn-Super-Resolution): an SRCNN-style convolutional
network for single-image super-resolution on the luma (Y) channel, with
JSON config, a bit-compatible JSON weights format, a train/forward CLI,
and tooling for sample generation, scheduling, profiling and weight
visualization — re-designed for an XLA accelerator:

- compute path: jitted XLA convolutions (NHWC; cuDNN on a GPU), with an
  im2col matmul formulation beside them, instead of per-pixel OpenCL
  work-items;
- gradients: ``jax.grad`` of the forward+loss (with the reference's
  backprop quirks replicated via a custom VJP gate) instead of
  hand-written delta/backprop kernels;
- scaling: ``jax.sharding.Mesh`` + jit/shard_map data-parallel training
  and halo-exchange spatial sharding, instead of the reference's
  single-device NDRange batching.

Package layout:
  utils/     config + parameters-file codecs, shared helpers
  models/    the generic layer-list SRCNN model family
  ops/       image/color ops, the PNG codec, on-device resizing
  optim/     the reference-exact SGD(momentum, weight-decay) update
  parallel/  mesh construction, data-parallel + spatial sharding
  training/  sample discovery, batching, the epoch loop
"""

__version__ = "0.1.0"
