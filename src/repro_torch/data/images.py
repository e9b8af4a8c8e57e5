"""Synthetic fingerprint-like images and noise models (paper §3.3, Table 10).

A copy of `fingerprint`, `inference_batch`, `add_salt_pepper` and `psnr`
from `repro.data.images`: numpy only, made from a `default_rng` seed, so
both packages see the same pixels. FVC2004 is not redistributable, so the PSNR
experiment uses a deterministic ridge-pattern generator.
"""
from __future__ import annotations

import numpy as np


def fingerprint(hw: tuple[int, int] = (256, 256), seed: int = 0) -> np.ndarray:
    """uint8 ridge-pattern image in [0, 255]."""
    h, w = hw
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = h / 2 + rng.uniform(-h / 8, h / 8), w / 2 + rng.uniform(-w / 8, w / 8)
    r = np.hypot(yy - cy, xx - cx)
    theta = np.arctan2(yy - cy, xx - cx)
    freq = 2 * np.pi / rng.uniform(7.0, 10.0)          # ridge period ~8 px
    phase = theta * rng.uniform(2.5, 4.0)              # whorl twist
    ridges = np.sin(freq * r + phase)
    ridges += 0.25 * rng.standard_normal((h, w))       # ink texture
    img = ((ridges - ridges.min()) / (np.ptp(ridges) + 1e-9) * 255.0)
    return img.astype(np.uint8)


def inference_batch(n: int, hw: tuple[int, int] = (8, 8), seed: int = 0) -> np.ndarray:
    """float32 batch in [0, 1], shape (n, *hw): box-downsampled fingerprint
    patches feeding the `repro_torch.infer` models. Deterministic in (n, hw,
    seed) so calibration sets and eval sets are reproducible."""
    h, w = hw
    out = np.empty((n, h, w), dtype=np.float32)
    for i in range(n):
        full = fingerprint((h * 4, w * 4), seed=seed + i).astype(np.float32)
        out[i] = full.reshape(h, 4, w, 4).mean(axis=(1, 3)) / 255.0
    return out


def add_salt_pepper(img: np.ndarray, percent: int, seed: int = 0) -> np.ndarray:
    """percent% of pixels forced to 0 or 255 (paper Table 10 noise sweep)."""
    rng = np.random.default_rng(seed + percent)
    out = img.copy()
    mask = rng.random(img.shape) < percent / 100.0
    salt = rng.random(img.shape) < 0.5
    out[mask & salt] = 255
    out[mask & ~salt] = 0
    return out


def psnr(base: np.ndarray, test: np.ndarray, peak: float = 255.0) -> float:
    """Paper eq. 30/31."""
    mse = np.mean((base.astype(np.float64) - test.astype(np.float64)) ** 2)
    return float(10.0 * np.log10(peak * peak / max(mse, 1e-12)))


__all__ = ["add_salt_pepper", "fingerprint", "inference_batch", "psnr"]
