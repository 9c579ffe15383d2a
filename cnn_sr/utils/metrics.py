"""Quality metrics: PSNR on the luma channel.

The reference publishes no PSNR (README shows only qualitative images —
SURVEY.md §6); the BASELINE contract for this rebuild is PSNR(Y) within
0.05 dB of the reference output on Set5-style images, so the metric
lives here as a first-class utility (used by tests and bench tooling).
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB between two arrays of the same
    shape (float images in 0..peak, or uint8 with peak=255)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = float(((a - b) ** 2).mean())
    if mse == 0:
        return float("inf")
    return 10.0 * float(np.log10(peak * peak / mse))


def psnr_y(rgb_a: np.ndarray, rgb_b: np.ndarray) -> float:
    """PSNR on the Rec.601 luma of two uint8 RGB images (the BASELINE
    'PSNR(Y)' metric)."""
    def luma(img):
        px = np.asarray(img, dtype=np.float64)
        return 0.299 * px[..., 0] + 0.587 * px[..., 1] + 0.114 * px[..., 2]

    return psnr(luma(rgb_a), luma(rgb_b), peak=255.0)


def uint8_parity(fast_u8: np.ndarray, ref_u8: np.ndarray, max_diff: int = 2,
                 mean_diff: float = 0.1, min_psnr: float = 60.0) -> dict:
    """Parity verdict of a uint8 image computed at reduced precision
    (``fast_u8``) against the f32 reference (``ref_u8``): max and mean
    absolute difference and PSNR, each against its gate."""
    d = np.abs(fast_u8.astype(np.int32) - ref_u8.astype(np.int32))
    mse = float(np.mean(d.astype(np.float64) ** 2))
    db = 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    return {
        "parity_ok": bool(d.max() <= max_diff and d.mean() <= mean_diff
                          and db >= min_psnr),
        "parity_max_diff": int(d.max()),
        "parity_mean_diff": round(float(d.mean()), 4),
        "parity_psnr_db": round(float(db), 2),
    }
