"""Inputs made from a seed: synthetic low-rank hyperspectral cubes with
missing pixels and Gaussian noise, the shipped dictionary, and the DIP net's
initial weights.

``synthetic_sample``, ``bernoulli_mask`` and ``corrupt`` are copies of the
port's ``lrs_pnp_dip_tpu_torch/data/masks.py`` functions of the same names
(numpy draws from ``np.random.default_rng``, so both give the same arrays
from one seed).  The benchmark keeps its own copy so that a change to the
program cannot change what it is measured on.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# Streams of seeds drawn from one run's seed, one per use.
PROBLEMS, DIP_INITS, CHECK_PICKS, ANSWER_SAMPLE, ORDER = range(5)


def sub_seeds(seed: int, n: int, stream: int = PROBLEMS) -> list:
    """``n`` seeds for numpy and torch from stream ``stream`` of the run's
    ``--seed`` (any whole number, negative or past 64 bits included)."""
    ss = np.random.SeedSequence(int(seed) % (1 << 128), spawn_key=(stream,))
    return [int(v) for v in ss.generate_state(n, dtype=np.uint64)]


def bernoulli_mask(shape, keep_prob: float, seed: int = 0) -> np.ndarray:
    """Random keep-mask: 1 with probability ``keep_prob``."""
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < keep_prob).astype(np.float32)


def corrupt(clean: np.ndarray, mask: np.ndarray, noise_sigma: float = 0.12, seed: int = 0) -> np.ndarray:
    """clean (H, W, B) + N(0, sigma^2) noise, then masked pixels zeroed."""
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
):
    """A synthetic low-rank problem: a rank-``rank`` mixture of smooth
    spatial abundance maps and smooth spectral endmembers.  Returns
    ``(noisy (H, W, B), mask (H, W), clean (H, W, B))``, float32."""
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
    return noisy, mask, clean


def problem_pool(seed: int, n: int, height: int, width: int, bands: int, rank: int,
                 missing: float, noise_sigma: float) -> list:
    """``n`` problems ``(noisy, mask, clean)`` drawn from ``seed``."""
    return [
        synthetic_sample(height, width, bands, rank, missing, noise_sigma, seed=s)
        for s in sub_seeds(seed, n)
    ]


def load_dictionary(path: Path) -> np.ndarray:
    """A shipped dictionary (a configuration's ``problem.dictionary``), float32,
    handed to the program and to the reference alike."""
    with np.load(path) as f:
        return np.asarray(f["dictionary"], dtype=np.float32)
