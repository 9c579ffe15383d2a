"""Two-process multihost integration test (real jax.distributed over
gloo CPU collectives — the capability the reference never had,
SURVEY.md §2.5).

Spawns 2 worker processes with 2 virtual CPU devices each; each feeds
its host-local half of the sample set and runs one data-parallel step
over the shared 4-device mesh. Asserts (a) both processes converge to
identical parameters, (b) they match a single-process 4-device run of
the same step (the multihost path changes nothing numerically).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
_WORKER = os.path.join(_HERE, "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_data_parallel_step(tmp_path):
    port = _free_port()
    outs = [str(tmp_path / f"w{i}.npz") for i in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), "2", str(port), outs[i]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        logs.append(out)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"

    a, b = np.load(outs[0]), np.load(outs[1])
    assert set(a.files) == set(b.files) and len(a.files) == 6
    for k in a.files:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=0,
                                   err_msg=f"{k} differs across processes")

    # single-process reference on a local 4-device mesh (conftest gives 8)
    import jax

    from cnn_sr.parallel.mesh import make_mesh
    from cnn_sr.training.trainer import init_train_state, make_train_step
    from cnn_sr.utils.config import parse_config

    from _multihost_worker import CFG  # same architecture/data recipe

    cfg = parse_config(CFG)
    state = init_train_state(cfg, seed=0)
    rng = np.random.default_rng(42)
    inputs = rng.random((4, 16, 16, 1), np.float32)
    gts = rng.random((4, 16, 16, 1), np.float32)
    mesh = make_mesh(n_data=4, devices=jax.devices()[:4])
    step = make_train_step(cfg, mesh=mesh)
    ref_params, _ = step(state.params, state.prev_delta, inputs, gts)
    for i, l in enumerate(ref_params):
        np.testing.assert_allclose(
            a[f"w{i}"], np.asarray(l["w"]), rtol=1e-6, atol=1e-7,
            err_msg=f"layer {i} weights: multihost vs single-process")
        np.testing.assert_allclose(
            a[f"b{i}"], np.asarray(l["b"]), rtol=1e-6, atol=1e-7)
