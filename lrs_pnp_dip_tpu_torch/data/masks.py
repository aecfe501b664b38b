"""Masks and synthetic corruption (counterpart of ``lrs_pnp_dip_tpu/data/masks.py``).

These stay numpy-level and draw from ``np.random.default_rng`` exactly as
the JAX package does, so both packages build identical inputs from a seed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .io import HsiSample


def bernoulli_mask(
    shape: Tuple[int, int], keep_prob: float, seed: int = 0
) -> np.ndarray:
    """Random keep-mask: 1 with probability ``keep_prob``."""
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < keep_prob).astype(np.float32)


def corrupt(
    clean: np.ndarray,
    mask: np.ndarray,
    noise_sigma: float = 0.12,
    seed: int = 0,
) -> np.ndarray:
    """clean (H,W,B) + N(0, sigma^2) noise, then masked pixels zeroed."""
    rng = np.random.default_rng(seed)
    noisy = clean + noise_sigma * rng.standard_normal(clean.shape)
    noisy = noisy * mask[..., None]
    return noisy.astype(np.float32)


def synthetic_sample(
    height: int = 36,
    width: int = 36,
    bands: int = 128,
    rank: int = 6,
    missing: float = 0.05,
    noise_sigma: float = 0.12,
    seed: int = 0,
) -> HsiSample:
    """A synthetic low-rank HSI problem: a rank-``rank`` mixture of smooth
    spatial abundance maps and smooth spectral endmembers."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    maps = []
    for _ in range(rank):
        cy, cx = rng.uniform(0, height), rng.uniform(0, width)
        s = rng.uniform(height / 6, height / 2)
        maps.append(np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))))
    A = np.stack(maps, -1)  # (H, W, R)
    t = np.linspace(0, 1, bands)
    E = np.stack(
        [
            0.5 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t + rng.uniform(0, 2 * np.pi))
            for _ in range(rank)
        ],
        0,
    )  # (R, B)
    clean = np.einsum("hwr,rb->hwb", A, E)
    clean = (clean - clean.min()) / (clean.max() - clean.min() + 1e-12) * 0.65
    clean = clean.astype(np.float32)
    mask = bernoulli_mask((height, width), 1.0 - missing, seed=seed + 1)
    noisy = corrupt(clean, mask, noise_sigma=noise_sigma, seed=seed + 2)
    return HsiSample(noisy=noisy, mask=mask, clean=clean, name="synthetic")
