"""The GPU-facing entry points, tested on the CPU: the refusal to
measure without a GPU, the compile-cache location, ``chip_smoke.py``'s
phases at tiny sizes, the profiler's lane selection on a trace recorded
on an H100, the reduced-precision forwards against HIGHEST, and the
Pillow-free PNG path of the CLI."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax

import chip_smoke
from cnn_sr.models import forward
from cnn_sr.profiling import op_shares
from cnn_sr.utils.compile_cache import DEFAULT_DIR
from cnn_sr.utils.config import read_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")


def _run(code):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_dir(env_dir, tmp_path):
    """Unset: the fixed ``<repo>/.jax_cache``. Set: left to JAX, which
    reads ``JAX_COMPILATION_CACHE_DIR`` itself."""
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; from cnn_sr.utils.compile_cache import "
         "configure_compile_cache as c; d = c(); "
         "print(d); print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**env, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    returned, configured = r.stdout.split()
    if env_dir:
        assert returned == configured == str(tmp_path / env_dir)
    else:
        assert returned == configured == DEFAULT_DIR
        assert DEFAULT_DIR == os.path.join(ROOT, ".jax_cache")


def test_bench_refuses_without_gpu():
    r = subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")],
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert "{" not in r.stdout


def test_chip_smoke_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and out.strip() == ""


@pytest.mark.parametrize("which", ["flagship", "9-1-5 widened"])
def test_chip_smoke_forward_phase_tiny(which, tmp_path):
    """Phases a and b at a tiny size. Both outputs are far from zero
    (pretrained weights; the 9-1-5 init widened to std 0.05), so the
    parity bound, relative to the output's peak, can fail."""
    cfg = (chip_smoke.FLAGSHIP if which == "flagship" else
           chip_smoke.widened_config(chip_smoke.SRCNN_915, str(tmp_path)))
    res = chip_smoke.phase_forward(cfg, 48, 64, 0, str(tmp_path), crop=16,
                                   log=lambda m: None)
    assert res["uint8_max_abs_diff"] <= 1
    assert res["float_max_abs_diff"] <= 1e-4 * res["float_max_abs_value"]
    assert res["float_max_abs_value"] > 1e-2


def test_widened_config_only_widens_the_weights(tmp_path):
    path = chip_smoke.widened_config(chip_smoke.SRCNN_915, str(tmp_path))
    wide, shipped = read_config(path), read_config(chip_smoke.SRCNN_915)
    assert wide.layer_specs() == shipped.layer_specs()
    assert [d.sd_w for d in wide.distributions] == [0.05] * 3
    assert [d.sd_b for d in wide.distributions] == [
        d.sd_b for d in shipped.distributions]


def test_chip_smoke_train_phase_tiny(tmp_path):
    res = chip_smoke.phase_train(chip_smoke.SRCNN_955, str(tmp_path), 0,
                                 count=10, size=32, epochs=4, short_epochs=2,
                                 log=lambda m: None)
    vals = res["highest"]["val_mse"]
    assert vals[-1] < vals[0]
    # the bound is on the epoch's update, so a missing update gives 1
    assert res["one_epoch_update_norm"] > 0
    assert res["one_epoch_update_rel_err_vs_cpu"] <= 1e-4
    assert res["bf16"]["epochs"] == res["default"]["epochs"] == 2


def test_chip_smoke_serve_phase_tiny():
    res = chip_smoke.phase_serve(
        [("default", chip_smoke.FLAGSHIP, 40, 50),
         ("rgb", chip_smoke.RGB, 30, 36)], 0, log=lambda m: None)
    assert [r["equal"] for r in res["requests"]] == [True, True]


def test_op_shares_reads_gpu_stream_lanes():
    """GPU traces name device lanes by CUDA stream ("Stream #13(Compute)"),
    with no "XLA Ops" lane; the fixture was recorded on an H100 running a
    two-layer conv stack twice."""
    rows = op_shares(os.path.join(FIXTURES, "gpu_trace"))
    names = [name for name, _, _ in rows]
    assert any("convolve" in n for n in names)
    assert "wrapped_transpose" in names
    total = sum(t for _, t, _ in rows)
    assert total == pytest.approx(19.103 + 2.176, rel=1e-6)
    assert {cnt for _, _, cnt in rows} == {4, 2}


def _precision_case(cfg_path, workdir, seed=1):
    """Params and a 48x48 network input for one shipped configuration;
    the 9-1-5 config has no checkpoint, so it is initialised with a
    wider weight spread (std 0.05) to give a non-trivial output."""
    from cnn_sr.training.trainer import init_train_state

    cfg = read_config(cfg_path)
    if not (cfg.parameters_file and os.path.isfile(cfg.parameters_file)):
        cfg = read_config(chip_smoke.widened_config(cfg_path, workdir))
    params = init_train_state(cfg, seed=seed).params
    rgba = chip_smoke._frame(np.random.default_rng(seed), 48, 48)
    x = rgba[..., :cfg.channels].astype(np.float32) / 255.0
    if cfg.channels == 1:
        x = (0.299 * rgba[..., :1] + 0.587 * rgba[..., 1:2]
             + 0.114 * rgba[..., 2:3]) / 255.0
    x = jnp.asarray((x - x.mean(axis=(0, 1)))[None], jnp.float32)
    return jax.tree.map(jnp.asarray, params), x


@pytest.mark.parametrize("cfg_name", [
    "srcnn_9-1-5.json", "srcnn_9-5-5_pretrained.json",
    "waifu2x_7layer_rgb_pretrained.json"])
def test_reduced_precision_forward_close_to_highest(cfg_name, tmp_path):
    """DEFAULT precision (TF32 on a Hopper GPU: a 10-bit mantissa, unit
    roundoff 2^-11) must stay within 1e-2 of the output's peak; the bf16
    forward of ``--train-precision bf16`` (8-bit mantissa, roundoff
    2^-9, compounded over up to 7 layers) within 5e-2. On the CPU
    DEFAULT is full f32, so that half holds to f32 rounding."""
    params, x = _precision_case(os.path.join(ROOT, "configs", cfg_name),
                                str(tmp_path))
    ref = np.asarray(forward(params, x))
    peak = float(np.abs(ref).max())
    assert peak > 1e-2
    tf32 = np.asarray(forward(params, x, precision=lax.Precision.DEFAULT))
    bf16 = np.asarray(forward(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), params),
        x.astype(jnp.bfloat16), precision=lax.Precision.DEFAULT)
        .astype(jnp.float32))
    assert np.abs(tf32 - ref).max() <= 1e-2 * peak
    assert np.abs(bf16 - ref).max() <= 5e-2 * peak
    assert np.abs(bf16 - ref).max() > 0  # bf16 really ran narrower


def test_cli_png_path_needs_no_pillow(tmp_path):
    """Upscaling a PNG through the CLI imports nothing beyond numpy and
    JAX: Pillow is made unimportable and must stay unloaded."""
    from cnn_sr.ops.png import encode_png

    src = tmp_path / "in.png"
    src.write_bytes(encode_png(chip_smoke._frame(
        np.random.default_rng(0), 40, 44)))
    r = _run(f"""
        import importlib.abc, sys
        class NoPillow(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "PIL" or name.startswith("PIL."):
                    raise ImportError("Pillow is not installed here")
        sys.meta_path.insert(0, NoPillow())
        from cnn_sr.cli import main
        rc = main(["-c", {chip_smoke.FLAGSHIP!r}, "-i", {str(src)!r},
                   "-o", {str(tmp_path / 'out.png')!r}])
        print("RC", rc, "PIL" in sys.modules)
    """)
    assert r.returncode == 0, r.stderr
    assert "RC 0 False" in r.stdout
    assert (tmp_path / "out.png").stat().st_size > 0


@pytest.mark.gpu
def test_chip_smoke_phases_full_size_on_gpu(gpu, tmp_path):
    """Phases a and e at full size on the card (run with
    ``JAX_PLATFORMS=cuda,cpu pytest -m gpu``)."""
    res = chip_smoke.phase_forward(chip_smoke.FLAGSHIP, 1080, 1920, 0,
                                   str(tmp_path), log=lambda m: None)
    assert res["uint8_max_abs_diff"] <= 1
    res = chip_smoke.phase_serve(
        [("default", chip_smoke.FLAGSHIP, 1080, 1920)], 0, log=lambda m: None)
    assert res["requests"][0]["equal"]


def test_time_scan_traces_once_and_reports_each_run():
    """One trace of the step (the scan compiles once), the first call's
    time, and one per-iteration time for each warm run."""
    from cnn_sr.utils.measure import time_scan

    seen = []

    def step(c):
        seen.append(c.shape)  # traced once
        return c + 1

    first, runs = time_scan(step, jnp.zeros((5, 7), jnp.float32), 4, 3)
    assert first > 0 and len(runs) == 3 and all(r > 0 for r in runs)
    assert seen == [(5, 7)]
