"""Debug-utility tests (dump_vector/print_array/transfer guard)."""

import numpy as np

import jax
import jax.numpy as jnp

from cnn_sr.utils.debug import dump_vector, print_array, warn_blocking_transfers


def test_dump_vector_formats_lines():
    out = dump_vector(np.arange(10, dtype=np.float32), per_line=4)
    lines = out.split("\n")
    assert len(lines) == 3
    assert lines[0].startswith("[0] 0, 1, 2, 3")
    assert lines[2].startswith("[2] 8, 9")


def test_print_array_stats():
    logs = []
    print_array("x", np.array([1.0, -2.0, 3.0]), log=logs.append)
    joined = "\n".join(logs)
    assert "shape=(3,)" in joined and "min=-2" in joined and "finite=True" in joined


def test_transfer_guard_context_runs():
    with warn_blocking_transfers(True):
        y = jax.jit(lambda x: x * 2)(jnp.ones(4))
        _ = np.asarray(y)  # logged, not raised
    with warn_blocking_transfers(False):
        _ = np.asarray(jnp.ones(2))
