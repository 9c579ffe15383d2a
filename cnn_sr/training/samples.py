"""Training-sample discovery and loading.

Equivalent of the reference's sample handling in Main_cl.cpp:

* ``find_training_samples`` ≙ get_training_samples (Main_cl.cpp:267-301):
  pair ``<base>_large.jpg`` / ``<base>_small.jpg`` files by basename,
  warn on unpaired or non-sample files. (We additionally accept .jpeg
  and .png extensions — a superset of the reference's .jpg-only rule.)
* ``load_sample_set`` ≙ the per-sample prepare_image + subtract_mean
  loop (Main_cl.cpp:132-149): decode both images, extract normalized
  luma, mean-subtract the *input* (small) luma only, and stack the set
  into contiguous (S, H, W, 1) device arrays — the analog of
  the reference's per-sample GPU buffers + copy_buffer batch packing
  (ConfigBasedDataPipeline.cpp:150-161).
* ``divide_samples`` ≙ divide_samples (Main_cl.cpp:244-261): shuffle ALL
  samples each epoch, first ``validation_size`` indices become the
  validation set (yes — membership is reshuffled every epoch, train/val
  leakage by design; replicated for parity).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..ops.color import extract_luma, subtract_mean
from ..ops.image import load_image

_SAMPLE_EXTS = (".jpg", ".jpeg", ".png")


def find_training_samples(dir_path: str) -> List[Tuple[str, str]]:
    """Return (large_path, small_path) pairs found in ``dir_path``."""
    by_base = {}
    for name in sorted(os.listdir(dir_path)):
        path = os.path.join(dir_path, name)
        if not os.path.isfile(path):
            continue
        stem, ext = os.path.splitext(name)
        if ext.lower() not in _SAMPLE_EXTS:
            print(f"'{name}' is not a sample image. Skipping")
            continue
        if stem.endswith("_large"):
            role, base = "large", stem[: -len("_large")]
        elif stem.endswith("_small"):
            role, base = "small", stem[: -len("_small")]
        else:
            print(f"'{name}' is not a sample image. Skipping")
            continue
        node = by_base.setdefault(base, {})
        if role in node:
            # e.g. x_large.jpg AND x_large.png after a --format switch
            # without cleaning: pairing either silently risks mixing a
            # stale file into the set — make the ambiguity fatal
            raise ValueError(
                f"ambiguous sample: both '{node[role]}' and '{path}' "
                f"claim {base}_{role}; remove one")
        node[role] = path

    pairs = []
    for base in sorted(by_base):
        node = by_base[base]
        if "large" not in node or "small" not in node:
            print(f"Only 1 image for pair with name '{base}'. Skipping sample")
            continue
        pairs.append((node["large"], node["small"]))
    return pairs


@dataclass
class SampleSet:
    """A loaded, batched training set: zero-mean input lumas and raw
    ground-truth lumas, both (S, H, W, 1) float32."""

    input_luma: np.ndarray     # mean-subtracted, normalized small-image luma
    expected_luma: np.ndarray  # normalized large-image luma (NOT mean-subtracted)
    width: int
    height: int

    @property
    def count(self) -> int:
        return self.input_luma.shape[0]

    @property
    def pixels_per_sample(self) -> int:
        return self.width * self.height


def load_sample_set(pairs: List[Tuple[str, str]], channels: int = 1,
                    zero_mean_target: bool = False,
                    squared_mean: bool = False) -> SampleSet:
    """Decode and preprocess all sample pairs into stacked arrays.

    ``channels=1`` (reference behavior): normalized Rec.601 luma, input
    mean-subtracted. ``channels=3`` (extended RGB models): normalized
    RGB, input mean-subtracted per channel; targets stay raw 0..1 in
    both cases. All samples must share one size (the reference sizes its
    shared batch buffers from samples[0] — Main_cl.cpp:152-154).

    ``zero_mean_target`` (config extension): targets become
    ``large − mean(small input)``, so the net learns mean-relative
    output (inference adds the input mean back). Removes the
    Var(per-image mean) error floor the reference's input-only
    subtraction imposes on data whose crop means vary.
    """
    if not pairs:
        raise ValueError("no training samples found")

    # the native C++ loader computes the plain mean; the squared-mean
    # binary-compat quirk (config subtract_squared_mean — see
    # ops/color.py:subtract_mean) takes the PIL path
    if channels == 1 and not zero_mean_target and not squared_mean:
        native_set = _load_sample_set_native(pairs)
        if native_set is not None:
            return native_set

    inputs, expecteds = [], []
    shape = None
    for large_path, small_path in pairs:
        large = load_image(large_path)
        small = load_image(small_path)
        if large.shape[:2] != small.shape[:2]:
            raise ValueError(
                f"sample pair size mismatch: {large_path} {large.shape[:2]} vs "
                f"{small_path} {small.shape[:2]}"
            )
        if shape is None:
            shape = large.shape[:2]
        elif large.shape[:2] != shape:
            raise ValueError(
                f"all samples must share one size; got {large.shape[:2]} vs {shape}"
            )
        if channels == 1:
            raw = np.asarray(extract_luma(small, normalize=True))[..., None]
            # input only (Main_cl.cpp:141)
            inp, in_mean = subtract_mean(raw, squared=squared_mean)
            inp = np.asarray(inp)
            exp = np.asarray(extract_luma(large, normalize=True))[..., None]
            if zero_mean_target:
                exp = exp - np.asarray(in_mean)
        else:
            inp = small[..., :3].astype(np.float32) / 255.0
            in_mean = inp.mean(axis=(0, 1), keepdims=True)
            inp = inp - in_mean
            exp = large[..., :3].astype(np.float32) / 255.0
            if zero_mean_target:
                exp = exp - in_mean
        inputs.append(inp)
        expecteds.append(exp)
    h, w = shape
    return SampleSet(
        input_luma=np.stack(inputs).astype(np.float32),
        expected_luma=np.stack(expecteds).astype(np.float32),
        width=w,
        height=h,
    )


def _load_sample_set_native(pairs: List[Tuple[str, str]]) -> Optional[SampleSet]:
    """Fast path: the native pthread-pooled batch loader (decode + luma +
    mean-subtract in C++ — cnn_sr.native). Returns None when the
    native library is unavailable or the set is inconsistent, letting the
    caller fall back to the PIL path."""
    try:
        from .. import native
    except ImportError:  # pragma: no cover
        return None
    if not native.available():
        return None
    try:
        w, h = native.image_size(pairs[0][0])
        larges = [p[0] for p in pairs]
        smalls = [p[1] for p in pairs]
        # input (small): normalized + per-image mean-subtract; target
        # (large): normalized only (Main_cl.cpp:132-149)
        inp = native.load_sample_batch(smalls, w, h, normalize=True, subtract_mean=True)
        exp = native.load_sample_batch(larges, w, h, normalize=True, subtract_mean=False)
    except IOError:
        return None
    return SampleSet(
        input_luma=inp[..., None],
        expected_luma=exp[..., None],
        width=w,
        height=h,
    )


def divide_samples(
    count: int, validation_size: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-epoch shuffle + split. Returns (train_idx, validation_idx)."""
    perm = rng.permutation(count)
    return perm[validation_size:], perm[:validation_size]
