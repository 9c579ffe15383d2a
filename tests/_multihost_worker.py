"""Subprocess worker for the two-process multihost integration test.

Run as: python _multihost_worker.py <pid> <nprocs> <port> <outfile>

Each process gets 2 virtual CPU devices; together they form a 4-device
"cluster". The worker initializes jax.distributed (gloo CPU
collectives), feeds its host-local half of the sample set through
``shard_host_local_batch``, runs one data-parallel training step over
the global mesh, and dumps the updated weights for cross-process and
vs-single-process comparison.
"""

import os
import sys

CFG = {
    "n1": 4, "n2": 2, "f1": 3, "f2": 1, "f3": 3,
    "momentum": 0.9, "weight_decay_parameter": 0.0001,
    "learning_rates": [0.01, 0.01, 0.001],
    **{
        f"parameters_distribution_{i}": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.01,
        }
        for i in (1, 2, 3)
    },
}

def main() -> None:
    pid, nprocs, port, outfile = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    import numpy as np

    from cnn_sr.parallel.multihost import (
        initialize_multihost, shard_host_local_batch)

    assert initialize_multihost(f"127.0.0.1:{port}", nprocs, pid)
    assert jax.process_count() == nprocs
    assert len(jax.devices()) == 2 * nprocs  # global devices

    from cnn_sr.parallel.mesh import make_mesh
    from cnn_sr.training.trainer import init_train_state, make_train_step
    from cnn_sr.utils.config import parse_config

    cfg = parse_config(CFG)
    state = init_train_state(cfg, seed=0)  # same seed -> identical everywhere

    rng = np.random.default_rng(42)  # the full deterministic sample set
    n_global = 2 * nprocs
    inputs = rng.random((n_global, 16, 16, 1), np.float32)
    gts = rng.random((n_global, 16, 16, 1), np.float32)

    mesh = make_mesh(n_data=2 * nprocs, devices=jax.devices())

    # host-local feeding: this process only "loads" its own half
    lo, hi = pid * 2, (pid + 1) * 2
    g_inputs = shard_host_local_batch(mesh, inputs[lo:hi])
    g_gts = shard_host_local_batch(mesh, gts[lo:hi])

    step = make_train_step(cfg, mesh=mesh)
    new_params, _ = step(state.params, state.prev_delta, g_inputs, g_gts)
    jax.block_until_ready(new_params)

    np.savez(
        outfile,
        **{f"w{i}": np.asarray(l["w"]) for i, l in enumerate(new_params)},
        **{f"b{i}": np.asarray(l["b"]) for i, l in enumerate(new_params)},
    )
    print(f"worker {pid}: OK", flush=True)


if __name__ == "__main__":
    main()
