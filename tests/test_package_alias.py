"""The package's former import name, kept as an alias package at the
repository root, resolves every submodule to the ``cnn_sr`` module
itself."""

import importlib
import os

import cnn_sr.api
import cnn_sr.utils.config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMER = [d for d in os.listdir(ROOT) if d.startswith("cnn_sr_")
          and os.path.isfile(os.path.join(ROOT, d, "__init__.py"))]


def test_there_is_one_alias_package():
    assert len(FORMER) == 1


def test_alias_submodules_are_the_cnn_sr_modules():
    api = importlib.import_module(f"{FORMER[0]}.api")
    config = importlib.import_module(f"{FORMER[0]}.utils.config")
    assert api is cnn_sr.api
    assert config.read_config is cnn_sr.utils.config.read_config
    # the modules keep their own import metadata
    assert cnn_sr.api.__name__ == cnn_sr.api.__spec__.name == "cnn_sr.api"
    alias = importlib.import_module(FORMER[0])
    assert alias.__version__ == cnn_sr.__version__
    assert getattr(alias, "api") is cnn_sr.api
