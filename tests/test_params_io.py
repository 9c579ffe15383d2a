"""Parameters-file codec tests: the `[f,f,k,n]` n-fastest layout contract
(layer_uber_kernel.cl:3-12), round-trips, and reference-format files."""

import numpy as np
import pytest

from cnn_sr.utils.config import LayerSpec
from cnn_sr.utils.params_io import (
    ParametersFileError,
    flat_to_hwio,
    hwio_to_flat,
    load_parameters_file,
    random_parameters,
    save_parameters_file,
)


def test_flat_layout_formula():
    # index(w[a,b,n,k]) = a·f·N·K + b·N·K + k·N + n (layer_uber_kernel.cl:3-12)
    f, K, N = 3, 2, 4
    flat = np.arange(f * f * K * N, dtype=np.float32)
    w = flat_to_hwio(flat, f, K, N)
    for a in range(f):
        for b in range(f):
            for k in range(K):
                for n in range(N):
                    idx = a * f * N * K + b * N * K + k * N + n
                    assert w[a, b, k, n] == flat[idx]
    np.testing.assert_array_equal(hwio_to_flat(w), flat)


def test_flat_size_mismatch():
    with pytest.raises(ParametersFileError):
        flat_to_hwio(np.zeros(10), 3, 2, 4)


SPECS = [
    LayerSpec(f=3, n_in=1, n_out=4, relu=True),
    LayerSpec(f=1, n_in=4, n_out=2, relu=True),
    LayerSpec(f=3, n_in=2, n_out=1, relu=False),
]


def test_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    params = [
        {
            "w": rng.standard_normal((s.f, s.f, s.n_in, s.n_out)).astype(np.float32),
            "b": rng.standard_normal((s.n_out,)).astype(np.float32),
        }
        for s in SPECS
    ]
    path = str(tmp_path / "params.json")
    save_parameters_file(path, params, epochs=42)
    loaded, epochs = load_parameters_file(path, SPECS)
    assert epochs == 42
    for got, want in zip(loaded, params):
        np.testing.assert_array_equal(got["w"], want["w"])  # bit-exact round trip
        np.testing.assert_array_equal(got["b"], want["b"])


def test_load_reference_format(tmp_path):
    # A hand-written file in exactly the reference README's documented
    # structure (README.md:92-113), with optional epochs omitted.
    content = """{
  "layer1":{
    "weights": [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],
    "bias": [0.5]
  },
  "layer2":{
    "weights": [0.25],
    "bias": [-1]
  }
}"""
    path = tmp_path / "ref.json"
    path.write_text(content)
    specs = [
        LayerSpec(f=2, n_in=3, n_out=1, relu=True),
        LayerSpec(f=1, n_in=1, n_out=1, relu=False),
    ]
    params, epochs = load_parameters_file(str(path), specs)
    assert epochs == 0  # optional on read
    assert params[0]["w"].shape == (2, 2, 3, 1)
    # idx = a·f·N·K + b·N·K + k·N + n with N=1, K=3, f=2
    assert params[0]["w"][0, 0, 0, 0] == 1
    assert params[0]["w"][0, 0, 2, 0] == 3
    assert params[0]["w"][0, 1, 0, 0] == 4
    assert params[0]["w"][1, 0, 0, 0] == 7
    assert params[0]["b"][0] == 0.5


def test_load_shape_mismatch(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text('{"layer1": {"weights": [1,2], "bias": [0]}}')
    with pytest.raises(ParametersFileError):
        load_parameters_file(str(path), [LayerSpec(f=3, n_in=1, n_out=1, relu=True)])


def test_random_parameters_shapes_and_distribution():
    from cnn_sr.utils.config import ParametersDistribution

    dists = [ParametersDistribution(0.0, 0.1, 0.005, 0.0)] * 3
    params = random_parameters(SPECS, dists, seed=7)
    for p, s in zip(params, SPECS):
        assert p["w"].shape == (s.f, s.f, s.n_in, s.n_out)
        assert p["b"].shape == (s.n_out,)
        # sd_b = 0 → bias deterministic at mean_b (ConfigBasedDataPipeline.cpp:372-377)
        np.testing.assert_allclose(p["b"], 0.1, atol=1e-7)
    big = random_parameters(
        [LayerSpec(f=9, n_in=8, n_out=64, relu=True)],
        [ParametersDistribution(0.0, 0.0, 0.005, 0.0)],
        seed=3,
    )
    assert abs(float(big[0]["w"].std()) - 0.005) < 0.0005
