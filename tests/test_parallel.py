"""Multi-device tests on the virtual 8-CPU mesh: data-parallel training
equivalence and halo-exchange spatial sharding correctness — coverage the
single-GPU reference never had (SURVEY.md §4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cnn_sr.parallel.mesh import make_mesh
from cnn_sr.parallel.spatial import sharded_forward
from cnn_sr.models import forward
from cnn_sr.training.trainer import init_train_state, make_train_step
from cnn_sr.utils.config import parse_config

CFG = {
    "n1": 4, "n2": 3, "f1": 3, "f2": 1, "f3": 3,
    "momentum": 0.9, "weight_decay_parameter": 0.0001,
    "learning_rates": [0.01, 0.01, 0.001],
    **{
        f"parameters_distribution_{i}": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.0,
        }
        for i in (1, 2, 3)
    },
}


@pytest.fixture(scope="module")
def devices():
    d = jax.devices()
    if len(d) < 8:
        pytest.skip("needs 8 virtual devices")
    return d


def _params(seed=0):
    cfg = parse_config(CFG)
    state = init_train_state(cfg, seed=seed)
    return cfg, jax.tree.map(jnp.asarray, state.params), jax.tree.map(
        jnp.asarray, state.prev_delta
    )


def test_mesh_construction(devices):
    mesh = make_mesh(n_data=4, n_spatial=2, devices=devices)
    assert mesh.shape == {"data": 4, "spatial": 2}
    with pytest.raises(ValueError):
        make_mesh(n_data=16, n_spatial=1, devices=devices)


def test_data_parallel_step_matches_single_device(devices):
    cfg, params, prev = _params()
    rng = np.random.default_rng(0)
    inputs = jnp.asarray(rng.standard_normal((8, 12, 12, 1)).astype(np.float32))
    gts = jnp.asarray(rng.uniform(0, 1, (8, 12, 12, 1)).astype(np.float32))

    p_single, d_single = make_train_step(cfg)(params, prev, inputs, gts)

    mesh = make_mesh(n_data=8, devices=devices)
    cfg2, params2, prev2 = _params()
    p_mesh, d_mesh = make_train_step(cfg2, mesh=mesh)(params2, prev2, inputs, gts)

    for a, b in zip(p_single, p_mesh):
        np.testing.assert_allclose(
            np.asarray(a["w"]), np.asarray(b["w"]), rtol=1e-5, atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(a["b"]), np.asarray(b["b"]), rtol=1e-5, atol=1e-6
        )
    for a, b in zip(d_single, d_mesh):
        np.testing.assert_allclose(
            np.asarray(a["w"]), np.asarray(b["w"]), rtol=1e-5, atol=1e-6
        )


@pytest.mark.parametrize("n_spatial", [2, 4])
def test_spatial_sharded_forward_matches_unsharded(devices, n_spatial):
    _, params, _ = _params(seed=1)
    rng = np.random.default_rng(2)
    # shrink = 2+0+2 = 4; H divisible by n_spatial, shard height ≥ shrink
    h, w = 8 * n_spatial, 20
    x = jnp.asarray(rng.standard_normal((1, h, w, 1)).astype(np.float32))

    mesh = make_mesh(n_data=1, n_spatial=n_spatial, devices=devices)
    y_sharded = sharded_forward(mesh, params, x)
    y_ref = forward(params, x)
    assert y_sharded.shape == y_ref.shape
    np.testing.assert_allclose(
        np.asarray(y_sharded), np.asarray(y_ref), rtol=1e-5, atol=1e-5
    )


def test_spatial_sharding_validates_shapes(devices):
    _, params, _ = _params()
    mesh = make_mesh(n_data=1, n_spatial=4, devices=devices)
    with pytest.raises(ValueError):
        sharded_forward(mesh, params, jnp.zeros((1, 30, 20, 1)))  # 30 % 4 != 0
    with pytest.raises(ValueError):
        sharded_forward(mesh, params, jnp.zeros((1, 8, 20, 1)))  # shard < shrink


def test_dryrun_multichip_entrypoint(devices):
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_entry_compiles(devices):
    import __graft_entry__ as g

    fn, args = g.entry()
    y = jax.jit(fn)(*args)
    jax.block_until_ready(y)
    assert y.shape[0] == 1 and y.shape[-1] == 1


def test_scanned_dispatch_over_mesh_matches_single(devices):
    """Multi-epoch scan dispatch with a data mesh must equal the
    single-device scanned path."""
    from cnn_sr.training.samples import SampleSet
    from cnn_sr.training.trainer import train_loop

    cfg = parse_config(CFG)
    rng = np.random.default_rng(9)
    samples = SampleSet(
        input_luma=rng.standard_normal((10, 12, 12, 1)).astype(np.float32),
        expected_luma=rng.uniform(0, 1, (10, 12, 12, 1)).astype(np.float32),
        width=12, height=12,
    )

    state_a = init_train_state(cfg, seed=4)
    assert not train_loop(cfg, samples, state_a, epochs=6, validation_cadence=2,
                          seed=5, epochs_per_dispatch=3, log=lambda *a: None)

    mesh = make_mesh(n_data=2, devices=devices)
    state_b = init_train_state(cfg, seed=4)
    assert not train_loop(cfg, samples, state_b, epochs=6, validation_cadence=2,
                          seed=5, epochs_per_dispatch=3, mesh=mesh,
                          log=lambda *a: None)

    for a, b in zip(state_a.params, state_b.params):
        np.testing.assert_allclose(a["w"], b["w"], rtol=1e-5, atol=1e-6)


def test_spatial_sharded_forward_rgb(devices):
    """Spatial sharding over an RGB model (3-channel in/out)."""
    rng = np.random.default_rng(12)
    params = [
        {"w": jnp.asarray(rng.standard_normal((3, 3, 3, 8)).astype(np.float32) * 0.1),
         "b": jnp.zeros(8)},
        {"w": jnp.asarray(rng.standard_normal((3, 3, 8, 3)).astype(np.float32) * 0.1),
         "b": jnp.zeros(3)},
    ]
    x = jnp.asarray(rng.standard_normal((1, 16, 20, 3)).astype(np.float32))
    mesh = make_mesh(n_data=1, n_spatial=4, devices=devices)
    y_sharded = sharded_forward(mesh, params, x)
    y_ref = forward(params, x)
    np.testing.assert_allclose(
        np.asarray(y_sharded), np.asarray(y_ref), rtol=1e-5, atol=1e-5
    )


def test_spatial_sharded_forward_three_layer_stack(devices):
    """``sharded_forward`` with no forward override on a 5-3-3 stack
    (shrink 8 across 2 shards of 40 rows), against the unsharded
    forward."""
    rng = np.random.default_rng(13)
    params = [
        {"w": jnp.asarray(rng.standard_normal((5, 5, 1, 8)).astype(np.float32) * 0.1),
         "b": jnp.zeros(8)},
        {"w": jnp.asarray(rng.standard_normal((3, 3, 8, 8)).astype(np.float32) * 0.1),
         "b": jnp.zeros(8)},
        {"w": jnp.asarray(rng.standard_normal((3, 3, 8, 1)).astype(np.float32) * 0.1),
         "b": jnp.zeros(1)},
    ]
    x = jnp.asarray(rng.standard_normal((1, 80, 150, 1)).astype(np.float32))
    mesh = make_mesh(n_data=1, n_spatial=2, devices=devices)
    y_sharded = sharded_forward(mesh, params, x)
    y_ref = forward(params, x)
    assert y_sharded.shape == y_ref.shape == (1, 72, 142, 1)
    np.testing.assert_allclose(
        np.asarray(y_sharded), np.asarray(y_ref), rtol=1e-5, atol=1e-5
    )


def test_upscale_image_spatial_rgb_and_luma(devices):
    """api.upscale_image_spatial end-to-end on the virtual mesh: both
    model families, including the bottom-pad (H % N != 0) path, must
    match the single-device api output."""
    from cnn_sr.api import upscale_image, upscale_image_spatial
    from cnn_sr.utils.config import parse_config
    from cnn_sr.utils.params_io import random_parameters

    rng = np.random.default_rng(21)
    # RGB model, 30 rows over 4 shards -> pad path
    cfg = parse_config({
        "channels": 3,
        "layers": [{"n": 8, "f": 3}, {"n": 8, "f": 3}, {"n": 3, "f": 3}],
        "momentum": 0.9, "weight_decay_parameter": 0.0,
        "learning_rates": [1e-3] * 3,
        "parameters_distribution": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.0},
    })
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=3)
    rgba = rng.integers(0, 256, (30, 40, 4), dtype=np.uint8)
    ref = upscale_image(cfg, params, rgba).astype(int)
    out = upscale_image_spatial(cfg, params, rgba, 4).astype(int)
    assert np.abs(out - ref).max() <= 1
    # luma model, exact-divisibility path
    cfg2 = parse_config({
        "n1": 6, "n2": 4, "f1": 5, "f2": 3, "f3": 3,
        "momentum": 0.9, "weight_decay_parameter": 0.0,
        "learning_rates": [1e-3] * 3,
        **{f"parameters_distribution_{i}": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.0,
        } for i in (1, 2, 3)},
    })
    params2 = random_parameters(cfg2.layer_specs(), cfg2.distributions, seed=4)
    rgba2 = rng.integers(0, 256, (32, 44, 4), dtype=np.uint8)
    ref2 = upscale_image(cfg2, params2, rgba2).astype(int)
    out2 = upscale_image_spatial(cfg2, params2, rgba2, 2).astype(int)
    assert np.abs(out2 - ref2).max() <= 1
