"""Load a parameters file written byte-faithfully in the REFERENCE's
own output format — the strongest load-compatibility evidence available
without a reference binary.

The fixture reproduces write_params_to_file exactly
(ConfigBasedDataPipeline.cpp:432-465 + dump_layer_parameters:419-430 +
utils::dump_vector pch.cpp:29-54): `{\\n  "epochs": N,\\n\\n  "layer1":{...`
with floats printed by C++ `operator<<` default formatting (6
significant digits, scientific below 1e-4) and NO trailing newline.
"""

import numpy as np

from cnn_sr.utils.config import LayerSpec
from cnn_sr.utils.params_io import (
    load_parameters_file, save_parameters_file)


def _cpp_float(v: float) -> str:
    """C++ default `ostream << float`: %g with 6 significant digits."""
    return f"{v:.6g}"


def _dump_vector(vals) -> str:
    return ", ".join(_cpp_float(v) for v in vals)


def _reference_file_text(epochs, layers) -> str:
    parts = ["{", f'  "epochs": {epochs},', ""]
    chunks = []
    for key, (w, b) in layers.items():
        chunks.append(
            f'  "{key}":{{\n'
            f'    "weights": [{_dump_vector(w)}],\n'
            f'    "bias": [{_dump_vector(b)}]\n'
            "  }"
        )
    return "\n".join(parts) + "\n" + ",\n".join(chunks) + "\n}"


def test_loads_reference_written_file(tmp_path):
    rng = np.random.default_rng(0)
    # tiny 3-5-3 net: layer1 1->2 f3, layer2 2->3 f1, layer3 3->1 f3
    specs = [LayerSpec(f=3, n_in=1, n_out=2, relu=True),
             LayerSpec(f=1, n_in=2, n_out=3, relu=True),
             LayerSpec(f=3, n_in=3, n_out=1, relu=False)]
    flat = {}
    layers = {}
    for key, s in zip(("layer1", "layer2", "layer3"), specs):
        # include values that exercise C++ default formatting: scientific
        # (<1e-4), negative, plain
        w = rng.standard_normal(s.f * s.f * s.n_in * s.n_out) * 0.01
        w[0] = 3.25e-05
        w[1] = -1.5
        b = rng.standard_normal(s.n_out) * 0.001
        flat[key] = (w, b)
        layers[key] = (w, b)

    text = _reference_file_text(7, layers)
    assert text.startswith('{\n  "epochs": 7,\n\n  "layer1":{')
    assert not text.endswith("\n")  # the reference writes no final newline
    assert "e-05" in text  # scientific notation present

    p = tmp_path / "parameters.json"
    p.write_text(text)
    params, epochs = load_parameters_file(str(p), specs)
    assert epochs == 7

    for (key, s), l in zip(zip(flat.keys(), specs), params):
        w_flat, b = flat[key]
        assert l["w"].shape == (s.f, s.f, s.n_in, s.n_out)
        # the reference flattens [f,f,k,n] n-fastest (layer_uber_kernel.cl:3-12)
        got_flat = l["w"].reshape(-1)
        # tolerance = the 6-significant-digit print truncation
        np.testing.assert_allclose(got_flat, w_flat, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(l["b"], b, rtol=1e-5, atol=1e-9)

    # and our writer round-trips the same values
    out = tmp_path / "rewritten.json"
    save_parameters_file(str(out), params, epochs=epochs)
    params2, epochs2 = load_parameters_file(str(out), specs)
    assert epochs2 == 7
    for a, b2 in zip(params, params2):
        np.testing.assert_array_equal(a["w"], b2["w"])
        np.testing.assert_array_equal(a["b"], b2["b"])
