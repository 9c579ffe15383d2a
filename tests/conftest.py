"""Test configuration: by default everything runs on a virtual 8-device
CPU platform.

Tests run on the CPU with 8 virtual devices
(``--xla_force_host_platform_device_count=8``) so the mesh/sharding tests
exercise real multi-device compilation without accelerators — the
fake-backend capability the reference's single-GPU test harness never
had (SURVEY.md §4). Must run before the first ``import jax``.

Tests marked ``gpu`` need a card: the ``gpu`` fixture skips them
elsewhere. On a machine with one, run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# repo root on sys.path so `import cnn_sr` works from any cwd
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, at run time, never while modules are imported."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX's first device is {dev.platform}); "
                    "run with JAX_PLATFORMS=cuda,cpu on a machine with one")
    return dev
