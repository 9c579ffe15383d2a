"""Config reader tests — the reference's ConfigTest matrix (ConfigTest.cpp:26-115):
ok / invalid value / non-parseable / missing file, asserting error class;
plus the extended layer-list schema."""

import json

import pytest

from cnn_sr.utils.config import (
    Config,
    ConfigError,
    ConfigValidationError,
    parse_config,
    read_config,
)

VALID = {
    "n1": 32,
    "n2": 16,
    "f1": 9,
    "f2": 1,
    "f3": 5,
    "momentum": 0.9,
    "weight_decay_parameter": 0.001,
    "learning_rates": [0.0001, 0.0001, 0.00001],
    "parameters_file": "data/parameters.json",
    "parameters_distribution_1": {
        "mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.005, "std_deviation_b": 0.0,
    },
    "parameters_distribution_2": {
        "mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.005, "std_deviation_b": 0.0,
    },
    "parameters_distribution_3": {
        "mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.005, "std_deviation_b": 0.0,
    },
}


def test_valid_config():
    cfg = parse_config(VALID)
    assert cfg.n1 == 32 and cfg.n2 == 16
    assert (cfg.f1, cfg.f2, cfg.f3) == (9, 1, 5)
    assert cfg.momentum == pytest.approx(0.9)
    assert cfg.weight_decay == pytest.approx(0.001)
    assert cfg.learning_rates == pytest.approx([1e-4, 1e-4, 1e-5])
    assert cfg.parameters_file == "data/parameters.json"
    assert cfg.channels == 1
    # total_padding = f1+f2+f3-3 (Config.cpp:44)
    assert cfg.total_padding() == 9 + 1 + 5 - 3


def test_subtract_squared_mean_flag():
    """Binary-compat quirk flag: off by default, parsed when present,
    rejected for RGB models (the quirk lives in the luma pipeline —
    docs/REFERENCE_PARITY.md)."""
    assert parse_config(VALID).subtract_squared_mean is False
    cfg = parse_config({**VALID, "subtract_squared_mean": True})
    assert cfg.subtract_squared_mean is True
    with pytest.raises(ConfigValidationError):
        parse_config({**VALID, "subtract_squared_mean": True, "channels": 3})


def test_layer_specs():
    specs = parse_config(VALID).layer_specs()
    assert [(s.f, s.n_in, s.n_out, s.relu) for s in specs] == [
        (9, 1, 32, True),
        (1, 32, 16, True),
        (5, 16, 1, False),  # last layer linear (SKIP_RELU)
    ]
    assert specs[0].weight_size == 81 * 32
    assert specs[1].weight_size == 1 * 32 * 16
    assert specs[2].out_size(20, 30) == (16, 26)


@pytest.mark.parametrize(
    "mutation",
    [
        {"f1": 8},                      # f must be odd
        {"f2": 0},                      # f must be > 0
        {"n1": 0},                      # n must be > 0
        {"weight_decay_parameter": -1}, # wd >= 0
        {"learning_rates": [0.0, 1e-4, 1e-4]},  # lr > 0
        {"learning_rates": [1e-4]},     # one lr per layer
        {"parameters_distribution_2": {
            "mean_w": 0, "mean_b": 0, "std_deviation_w": 0, "std_deviation_b": 0}},
    ],
)
def test_invalid_values(mutation):
    raw = dict(VALID)
    raw.update(mutation)
    with pytest.raises(ConfigValidationError):
        parse_config(raw)


def test_distribution_abs_normalization():
    # fix_params_distribution takes |x| of every field (Config.cpp:87-92)
    raw = dict(VALID)
    raw["parameters_distribution_1"] = {
        "mean_w": -0.5, "mean_b": -0.25, "std_deviation_w": -0.005, "std_deviation_b": -0.1,
    }
    cfg = parse_config(raw)
    d = cfg.distributions[0]
    assert (d.mean_w, d.mean_b, d.sd_w, d.sd_b) == (0.5, 0.25, 0.005, 0.1)


def test_missing_field():
    raw = dict(VALID)
    del raw["n1"]
    with pytest.raises(ConfigError):
        parse_config(raw)


def test_non_parseable_file(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("{ not json !!!")
    with pytest.raises(ConfigError):
        read_config(str(p))


def test_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_config(str(tmp_path / "nope.json"))


def test_read_valid_file(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(VALID))
    cfg = read_config(str(p))
    assert cfg.n1 == 32
    assert isinstance(str(cfg), str)  # pretty-print works


def test_extended_layer_list_rgb():
    raw = {
        "channels": 3,
        "layers": [
            {"n": 32, "f": 3}, {"n": 32, "f": 3}, {"n": 64, "f": 3},
            {"n": 64, "f": 3}, {"n": 128, "f": 3}, {"n": 128, "f": 3},
            {"n": 3, "f": 3},
        ],
        "momentum": 0.9,
        "weight_decay_parameter": 0.0,
        "learning_rates": [1e-4] * 7,
        "parameters_distribution": {
            "mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.01, "std_deviation_b": 0.0,
        },
    }
    cfg = parse_config(raw)
    assert cfg.num_layers == 7
    assert cfg.channels == 3
    specs = cfg.layer_specs()
    assert specs[0].n_in == 3
    assert specs[-1].n_out == 3 and not specs[-1].relu
    assert all(s.relu for s in specs[:-1])
    assert cfg.total_padding() == 7 * 2


def test_parameters_file_config_relative_fallback(tmp_path, monkeypatch):
    """A relative parameters_file that misses from the cwd resolves
    relative to the config file (shipped pretrained configs work from
    any working directory); cwd-relative wins when it exists, and a
    path that resolves nowhere is kept as-is (training semantics:
    warn + fresh init)."""
    import json as _json
    import os

    from cnn_sr.utils.config import read_config

    base = {
        "n1": 4, "n2": 2, "f1": 3, "f2": 1, "f3": 3,
        "momentum": 0.9, "weight_decay_parameter": 0.0,
        "learning_rates": [1e-3, 1e-3, 1e-4],
        **{f"parameters_distribution_{i}": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.0,
        } for i in (1, 2, 3)},
    }
    cfgdir = tmp_path / "configs"
    cfgdir.mkdir()
    (cfgdir / "w.json").write_text("{}")  # the config-relative target
    cwd = tmp_path / "elsewhere"
    cwd.mkdir()
    monkeypatch.chdir(str(cwd))

    p = cfgdir / "cfg.json"
    p.write_text(_json.dumps(dict(base, parameters_file="w.json")))
    cfg = read_config(str(p))
    assert os.path.samefile(cfg.parameters_file, str(cfgdir / "w.json"))

    # cwd-relative wins when it exists (reference behavior)
    (cwd / "w.json").write_text("{}")
    cfg = read_config(str(p))
    assert cfg.parameters_file == "w.json"

    # resolves nowhere -> kept as-is
    p.write_text(_json.dumps(dict(base, parameters_file="nope.json")))
    assert read_config(str(p)).parameters_file == "nope.json"
