"""Former import name of :mod:`cnn_sr`, kept so that existing imports
keep working. Every submodule resolves to the ``cnn_sr`` module itself
(one module object under two names), so ``import <old>.api`` and
``import cnn_sr.api`` share state and compiled programs. New code
imports ``cnn_sr``."""

import importlib
import importlib.abc
import importlib.util
import sys

from cnn_sr import __version__  # noqa: F401

_PREFIX = __name__ + "."


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Finds ``<old>.X`` and loads it as the already-importable
    ``cnn_sr.X``."""

    def find_spec(self, name, path=None, target=None):
        if not name.startswith(_PREFIX):
            return None
        return importlib.util.spec_from_loader(name, self)

    def create_module(self, spec):
        module = importlib.import_module("cnn_sr." + spec.name[len(_PREFIX):])
        # the import system stamps the alias spec on the module; keep
        # the real one to put back in exec_module
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        module.__spec__ = module.__spec__.loader_state


if not any(isinstance(f, _Alias) for f in sys.meta_path):
    sys.meta_path.insert(0, _Alias())
