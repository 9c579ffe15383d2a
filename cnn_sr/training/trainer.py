"""The training loop: one fused jitted step per epoch + host-side orchestration.

The JAX equivalent of the reference's epoch loop (Main_cl.cpp:161-195)
and execute_batch/update_parameters machinery
(ConfigBasedDataPipeline.cpp:128-195, 325-361):

* the reference chains 9 kernels per mini-batch (3 forward, 1 last-delta,
  2 deltas, 3 backprop) plus a per-layer update kernel, with cl_event
  dependencies and grad accumulation across mini-batches; here the WHOLE
  epoch — forward + backward over the full train set + the SGD update —
  is ONE jitted XLA program with donated parameter buffers, so weights
  never leave device memory and XLA fuses/schedules the chain;
* gradients are raw sums over the train set (see models.srcnn.loss_sum)
  and the update divides by the train-set size, exactly as the reference;
* per-epoch reshuffled 20% validation split (divide_samples), validation
  MSE every 25 epochs and on the last epoch, NaN abort with error status
  (Main_cl.cpp:174-192);
* optional gradient chunking (``mini_batch_count``) re-creates the
  reference's mini-batch memory bound via ``lax.map`` over static chunks
  — numerically the same raw-sum gradient.

Multi-chip: pass a ``jax.sharding.Mesh`` — the batch dimension is sharded
over the ``"data"`` axis and XLA inserts the gradient ``psum`` (the
replacement for the reference's atomic gradient accumulation,
SURVEY.md §2.5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import loss_sum, luma_mse_metrics
from ..optim import init_optimizer_state, update_parameters
from ..utils.cache import LRUCache
from ..utils.config import Config
from .samples import SampleSet, divide_samples


@dataclass
class TrainState:
    """Parameters + momentum buffers + the persistent epoch counter
    (the reference's ``epochs`` field, serialized in the params file)."""

    params: list
    prev_delta: list
    epochs: int = 0


def _grads(params, inputs, gts, num_chunks: int, precision=None,
           relu_gate: bool = True):
    """Raw-sum gradients over the batch, optionally accumulated in
    ``num_chunks`` sequential chunks to bound activation memory (the
    reference's mini-batch split, Main_cl.cpp:92-93,128).

    ``precision``: conv precision (None = HIGHEST, true f32, the
    exact-parity default; ``lax.Precision.HIGH``/``DEFAULT`` run f32
    convs in TF32 on a Hopper GPU). The string
    ``"bf16"`` selects mixed-precision training instead: bf16
    forward/backward against f32 master weights with f32 gradient
    accumulation (models.loss_sum ``compute_dtype``).
    ``relu_gate``: the reference's last-layer ReLU' quirk (see
    models.loss_sum)."""
    if precision == "bf16":
        kw = {"compute_dtype": jnp.bfloat16}
    else:
        kw = {} if precision is None else {"precision": precision}
    kw["relu_gate"] = relu_gate
    if num_chunks <= 1:
        return jax.grad(loss_sum)(params, inputs, gts, **kw)
    s = inputs.shape[0]
    chunk = s // num_chunks  # caller guarantees divisibility
    xs = inputs.reshape(num_chunks, chunk, *inputs.shape[1:])
    ts = gts.reshape(num_chunks, chunk, *gts.shape[1:])

    def body(carry, xt):
        x, t = xt
        g = jax.grad(loss_sum)(params, x, t, **kw)
        return jax.tree.map(lambda a, b: a + b, carry, g), None

    zero = jax.tree.map(jnp.zeros_like, params)
    acc, _ = jax.lax.scan(body, zero, (xs, ts))
    return acc


# Compiled-step caches: jit caches key on the function object, so a fresh
# closure per call would recompile the (expensive) epoch programs on every
# train_loop invocation. Keyed on the hyperparameters that are baked into
# the trace; array shapes still re-specialize inside jit as usual.
# Bounded LRU so long-lived processes that churn meshes/hyperparameters
# don't accumulate compiled programs without limit.
_STEP_CACHE = LRUCache(maxsize=16)


def _cache_key(kind, cfg, num_chunks, mesh, precision=None):
    return (kind, tuple(cfg.learning_rates), cfg.momentum, cfg.weight_decay,
            cfg.last_layer_relu_gate, num_chunks, mesh, precision)


def make_train_step(
    cfg: Config,
    mesh=None,
    num_chunks: int = 1,
    precision=None,
) -> Callable:
    """Build the jitted epoch step:
    ``(params, prev_delta, inputs, gts) -> (params', prev_delta')``.

    ``inputs``/``gts``: (T, H, W, C). The update divides by T (the
    reference passes train_set.size() as batch_size — Main_cl.cpp:167-170).
    ``precision``: see ``_grads``.
    """
    key = _cache_key("single", cfg, num_chunks, mesh, precision)
    if key in _STEP_CACHE:
        return _STEP_CACHE[key]

    lrs = tuple(cfg.learning_rates)
    momentum, wd = cfg.momentum, cfg.weight_decay

    relu_gate = cfg.last_layer_relu_gate

    def step(params, prev_delta, inputs, gts):
        grads = _grads(params, inputs, gts, num_chunks, precision, relu_gate)
        return update_parameters(
            params, prev_delta, grads, lrs, momentum, wd, inputs.shape[0]
        )

    donate = jax.jit(step, donate_argnums=(0, 1))
    if mesh is None:
        _STEP_CACHE[key] = donate
        return donate

    from ..parallel.data_parallel import shard_batch, replicate

    def sharded_step(params, prev_delta, inputs, gts):
        inputs = shard_batch(mesh, inputs)
        gts = shard_batch(mesh, gts)
        params = replicate(mesh, params)
        prev_delta = replicate(mesh, prev_delta)
        return donate(params, prev_delta, inputs, gts)

    _STEP_CACHE[key] = sharded_step
    return sharded_step


def make_multi_epoch_step(cfg: Config, num_chunks: int = 1, mesh=None,
                          precision=None) -> Callable:
    """Build a jitted multi-epoch step: ``lax.scan`` over K epochs in ONE
    dispatch — (params, prev, inputs, gts, train_idx[K,T], val_idx[K,V],
    do_val[K]) → (params', prev', val_errs[K]).

    Semantically identical to K iterations of the single-epoch loop (the
    per-epoch shuffle/split happens on host and arrives as index
    arrays); it amortizes host→device dispatch latency across K
    epochs and keeps parameters on-device throughout. ``val_errs[k]`` is
    the post-update validation squared error when ``do_val[k]`` else -1.
    """
    key = _cache_key("multi", cfg, num_chunks, mesh, precision)
    if key in _STEP_CACHE:
        return _STEP_CACHE[key]

    lrs = tuple(cfg.learning_rates)
    momentum, wd = cfg.momentum, cfg.weight_decay
    relu_gate = cfg.last_layer_relu_gate

    def step(params, prev_delta, inputs, gts, train_idx, val_idx, do_val):
        def body(carry, xs):
            params, prev = carry
            t_idx, v_idx, dv = xs
            x = jnp.take(inputs, t_idx, axis=0)
            t = jnp.take(gts, t_idx, axis=0)
            grads = _grads(params, x, t, num_chunks, precision, relu_gate)
            params, prev = update_parameters(
                params, prev, grads, lrs, momentum, wd, t_idx.shape[0]
            )
            err = jax.lax.cond(
                dv,
                lambda p: luma_mse_metrics(
                    p, jnp.take(inputs, v_idx, axis=0), jnp.take(gts, v_idx, axis=0)
                ),
                lambda p: jnp.float32(-1.0),
                params,
            )
            return (params, prev), err

        (params, prev_delta), errs = jax.lax.scan(
            body, (params, prev_delta), (train_idx, val_idx, do_val)
        )
        return params, prev_delta, errs

    jitted = jax.jit(step, donate_argnums=(0, 1))
    if mesh is None:
        _STEP_CACHE[key] = jitted
        return jitted

    from ..parallel.data_parallel import replicate, shard_batch

    def sharded(params, prev_delta, inputs, gts, train_idx, val_idx, do_val):
        # samples sharded over "data"; the per-epoch gathers then index a
        # sharded batch axis and XLA inserts the psum on the raw-sum grads
        return jitted(
            replicate(mesh, params), replicate(mesh, prev_delta),
            shard_batch(mesh, inputs), shard_batch(mesh, gts),
            train_idx, val_idx, do_val,
        )

    _STEP_CACHE[key] = sharded
    return sharded


def make_validation_fn(mesh=None) -> Callable:
    """Jitted validation: total squared error over the set
    (execute_batch(false, ...), ConfigBasedDataPipeline.cpp:178-187)."""
    fn = jax.jit(luma_mse_metrics)
    if mesh is None:
        return fn

    from ..parallel.data_parallel import shard_batch

    def sharded(params, inputs, gts):
        return fn(params, shard_batch(mesh, inputs), shard_batch(mesh, gts))

    return sharded


def train_loop(
    cfg: Config,
    samples: SampleSet,
    state: TrainState,
    epochs: int,
    *,
    validation_percent: int = 20,   # hardcoded in the reference (Main_cl.cpp:92)
    mini_batch_count: int = 1,      # memory chunking; 2 in the reference (Main_cl.cpp:93)
    validation_cadence: int = 25,   # Main_cl.cpp:174
    epochs_per_dispatch: int = 1,   # >1: lax.scan K epochs per device dispatch
    mesh=None,
    precision=None,                 # None=HIGHEST parity; HIGH/DEFAULT=TF32; "bf16"=mixed
    seed: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,  # overrides seed (resume)
    log: Callable[[str], None] = print,
    on_epoch: Optional[Callable[[int, Optional[float]], None]] = None,
) -> bool:
    """Run ``epochs`` epochs, mutating ``state``. Returns True on error
    (NaN validation loss — Main_cl.cpp:179-184)."""
    if rng is None:
        rng = np.random.default_rng(seed)
    s = samples.count
    validation_size = int(s * validation_percent / 100.0)
    train_size = s - validation_size
    if validation_size == 0:
        log("[WARNING] Validation set is empty")
    else:
        log(
            f"validation_set_size: {validation_size}/{s} = "
            f"{validation_size * 100.0 / s}%"
        )

    num_chunks = 1
    if mini_batch_count > 1:
        # pick the largest chunk count <= mini_batch_count dividing train_size
        for c in range(min(mini_batch_count, train_size), 0, -1):
            if train_size % c == 0:
                num_chunks = c
                break

    inputs = jnp.asarray(samples.input_luma)
    gts = jnp.asarray(samples.expected_luma)

    params = jax.tree.map(jnp.asarray, state.params)
    prev = jax.tree.map(jnp.asarray, state.prev_delta)

    def _is_val_epoch(e):
        return validation_size > 0 and ((e % validation_cadence) == 0 or e == epochs - 1)

    if epochs_per_dispatch > 1 and epochs > 1:
        step_k = make_multi_epoch_step(cfg, num_chunks=num_chunks, mesh=mesh,
                                       precision=precision)
        error = False
        epoch_id = 0
        while epoch_id < epochs and not error:
            k = min(epochs_per_dispatch, epochs - epoch_id)
            t_rows, v_rows, dv = [], [], []
            for i in range(k):
                t_idx, v_idx = divide_samples(s, validation_size, rng)
                t_rows.append(t_idx)
                v_rows.append(v_idx)
                dv.append(_is_val_epoch(epoch_id + i))
            params, prev, errs = step_k(
                params, prev, inputs, gts,
                jnp.asarray(np.stack(t_rows)),
                jnp.asarray(np.stack(v_rows)) if validation_size > 0
                else jnp.zeros((k, 0), jnp.int32),
                jnp.asarray(dv),
            )
            errs = np.asarray(errs)
            state.epochs += k
            for i in range(k):
                val_err = float(errs[i]) if dv[i] else None
                if val_err is not None:
                    if not math.isfinite(val_err):
                        log(f"Error: squared error is NAN/Inf, after "
                            f"{epoch_id + i}/{epochs} epochs")
                        error = True
                        break
                    mean_err = val_err / validation_size
                    log(f"[{epoch_id + i}] mean validation error: {mean_err} "
                        f"({mean_err / samples.pixels_per_sample} per px)")
                if on_epoch is not None:
                    on_epoch(epoch_id + i, val_err)
            epoch_id += k
        state.params = [
            {"w": np.asarray(l["w"]), "b": np.asarray(l["b"])} for l in params
        ]
        state.prev_delta = [
            {"w": np.asarray(l["w"]), "b": np.asarray(l["b"])} for l in prev
        ]
        return error

    step = make_train_step(cfg, mesh=mesh, num_chunks=num_chunks,
                           precision=precision)
    validate = make_validation_fn(mesh=mesh)

    error = False
    for epoch_id in range(epochs):
        train_idx, val_idx = divide_samples(s, validation_size, rng)
        params, prev = step(params, prev, inputs[train_idx], gts[train_idx])
        state.epochs += 1  # ++epochs per update (ConfigBasedDataPipeline.cpp:360)

        val_err = None
        if _is_val_epoch(epoch_id):
            val_err = float(validate(params, inputs[val_idx], gts[val_idx]))
            # the reference aborts on NaN only (Main_cl.cpp:179-184); we
            # also abort on inf — a diverged run is equally unrecoverable
            # and the reference would loop printing 'inf' forever
            if not math.isfinite(val_err):
                log(
                    f"Error: squared error is NAN/Inf, after {epoch_id}/{epochs} epochs"
                )
                error = True
                break
            mean_err = val_err / validation_size
            log(
                f"[{epoch_id}] mean validation error: {mean_err} "
                f"({mean_err / samples.pixels_per_sample} per px)"
            )
        if on_epoch is not None:
            on_epoch(epoch_id, val_err)

    state.params = [
        {"w": np.asarray(l["w"]), "b": np.asarray(l["b"])} for l in params
    ]
    state.prev_delta = [
        {"w": np.asarray(l["w"]), "b": np.asarray(l["b"])} for l in prev
    ]
    return error


def init_train_state(cfg: Config, seed: Optional[int] = None) -> TrainState:
    """Fresh state: load ``cfg.parameters_file`` if set, else random init
    (ConfigBasedDataPipeline::init, ConfigBasedDataPipeline.cpp:32-52)."""
    import os

    from ..utils.params_io import load_parameters_file, random_parameters

    specs = cfg.layer_specs()
    epochs = 0
    if cfg.parameters_file and os.path.isfile(cfg.parameters_file):
        params, epochs = load_parameters_file(cfg.parameters_file, specs)
    else:
        if cfg.parameters_file:
            print(
                f"[Warning] parameters file '{cfg.parameters_file}' not found, "
                "using random initialization"
            )
        params = random_parameters(specs, cfg.distributions, seed=seed)
    state = TrainState(params=params, prev_delta=None, epochs=epochs)
    state.prev_delta = [
        {"w": np.zeros_like(l["w"]), "b": np.zeros_like(l["b"])} for l in params
    ]
    return state
