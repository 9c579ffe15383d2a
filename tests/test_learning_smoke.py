"""Learning smoke test: the full training stack actually optimizes.

Drives train_loop end-to-end (sample set → epochs → update) on a tiny
synthetic deblurring problem and asserts the training-set error drops
by a large factor. Uses the zero_mean_target + gate-off extension mode
(docs/TRAINING.md) — the reference-parity mode's mean floor would mask
optimization progress on synthetic data.
"""

import numpy as np

from cnn_sr.models import luma_mse_metrics
from cnn_sr.training.samples import SampleSet
from cnn_sr.training.trainer import init_train_state, train_loop
from cnn_sr.utils.config import parse_config

CFG = {
    "n1": 8, "n2": 4, "f1": 5, "f2": 1, "f3": 3,
    "momentum": 0.9, "weight_decay_parameter": 0.0,
    "learning_rates": [1e-3, 1e-3, 1e-4],
    "zero_mean_target": True,
    **{
        f"parameters_distribution_{i}": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.02, "std_deviation_b": 0.0,
        }
        for i in (1, 2, 3)
    },
}


def _blur(x):
    """3-tap box blur along both axes (the degradation to invert)."""
    k = np.ones(3) / 3.0
    y = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1, x)
    return np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 2, y)


def test_training_reduces_error_end_to_end():
    rng = np.random.default_rng(0)
    n, hw = 16, 24
    # structured targets: random low-frequency patterns with edges
    t = (rng.random((n, hw, hw)) > 0.5).astype(np.float32)
    for _ in range(2):
        t = _blur(t)
    gt = t[..., None].astype(np.float32)
    blurred = _blur(t)[..., None].astype(np.float32)
    means = blurred.mean(axis=(1, 2), keepdims=True)
    samples = SampleSet(
        input_luma=(blurred - means).astype(np.float32),
        expected_luma=(gt - means).astype(np.float32),  # zero_mean_target
        width=hw, height=hw,
    )

    cfg = parse_config(CFG)
    assert cfg.last_layer_relu_gate is False  # implied by zero_mean_target
    state = init_train_state(cfg, seed=0)

    import jax.numpy as jnp

    x = jnp.asarray(samples.input_luma)
    y = jnp.asarray(samples.expected_luma)

    def err(params):
        p = [{"w": jnp.asarray(l["w"]), "b": jnp.asarray(l["b"])}
             for l in params]
        return float(luma_mse_metrics(p, x, y))

    e0 = err(state.params)
    error = train_loop(cfg, samples, state, 400, validation_percent=0,
                       seed=0, log=lambda *_: None)
    assert not error
    e1 = err(state.params)
    # measured ~15x at this lr; 5x leaves headroom for backend variation
    assert e1 < e0 / 5, f"training barely moved: {e0} -> {e1}"

    # mixed-precision mode must optimize the same problem (bf16
    # forward/backward, f32 master weights — models.loss_sum compute_dtype)
    state_bf16 = init_train_state(cfg, seed=0)
    error = train_loop(cfg, samples, state_bf16, 400, validation_percent=0,
                       seed=0, precision="bf16", log=lambda *_: None)
    assert not error
    e1_bf16 = err(state_bf16.params)
    assert e1_bf16 < e0 / 5, f"bf16 training barely moved: {e0} -> {e1_bf16}"


def test_bf16_grads_match_f32_direction():
    """bf16 compute gradients stay f32-typed (master-weight scheme) and
    point the same way as the exact-parity gradients."""
    import jax
    import jax.numpy as jnp

    from cnn_sr.models import loss_sum
    from cnn_sr.utils.params_io import random_parameters

    cfg = parse_config(CFG)
    params = [
        {"w": jnp.asarray(p["w"]), "b": jnp.asarray(p["b"])}
        for p in random_parameters(cfg.layer_specs(), cfg.distributions, seed=3)
    ]
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.random((2, 20, 20, 1), np.float32))
    t = jnp.asarray(rng.random((2, 20, 20, 1), np.float32))

    g32 = jax.grad(loss_sum)(params, x, t, relu_gate=False)
    g16 = jax.grad(loss_sum)(params, x, t, relu_gate=False,
                             compute_dtype=jnp.bfloat16)
    for l32, l16 in zip(g32, g16):
        for k in ("w", "b"):
            assert l16[k].dtype == jnp.float32
            a = np.asarray(l32[k]).ravel()
            b = np.asarray(l16[k]).ravel()
            cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos > 0.99, (k, cos)
            # magnitudes agree to bf16-roundoff scale
            assert np.linalg.norm(b - a) < 0.05 * np.linalg.norm(a) + 1e-6
