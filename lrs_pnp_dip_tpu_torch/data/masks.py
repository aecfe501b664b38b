"""Masks and synthetic corruption (counterpart of ``lrs_pnp_dip_tpu/data/masks.py``).

These stay numpy-level and draw from ``np.random.default_rng`` exactly as
the JAX package does, so both packages build identical inputs from a seed.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .io import HsiSample


def bernoulli_mask(
    shape: Tuple[int, int], keep_prob: float, seed: int = 0
) -> np.ndarray:
    """Random keep-mask: 1 with probability ``keep_prob``."""
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < keep_prob).astype(np.float32)


def strip_mask(
    shape: Tuple[int, int],
    strips: Sequence[Tuple[int, int, int, int]],
) -> np.ndarray:
    """Mask with rectangular dead regions: ``strips`` holds (row0, row1,
    col0, col1) half-open boxes marked missing (0), as the MATLAB twin's
    hand-built strip masks."""
    mask = np.ones(shape, dtype=np.float32)
    for r0, r1, c0, c1 in strips:
        mask[r0:r1, c0:c1] = 0.0
    return mask


#: The MATLAB twin's strip boxes (``main_LRS_PnP.m:34-38``, there 1-indexed
#: and inclusive), as 0-indexed half-open (row0, row1, col0, col1): 66 of the
#: 1296 pixels.
MATLAB_STRIPS = (
    (7, 13, 26, 28),
    (3, 5, 6, 12),
    (17, 24, 4, 6),
    (15, 17, 12, 19),
    (23, 25, 12, 19),
)


def matlab_strip_mask(shape: Tuple[int, int] = (36, 36)) -> np.ndarray:
    """The strip mask of ``main_LRS_PnP.m:31-43`` (36x36, 66 dead pixels,
    the same in every band)."""
    return strip_mask(shape, MATLAB_STRIPS)


def matlab_twin_sample(seed: int = 0, bands: int = 128) -> HsiSample:
    """The MATLAB-twin experiment's input (``main_LRS_PnP.m:4-47``): a
    36x36x``bands`` synthetic low-rank clean cube (rank 8; the reference's
    Chikusei crop is not available), sigma 0.12 gaussian noise on every
    pixel, then the strip mask zeroing 66 pixels in every band."""
    base = synthetic_sample(
        height=36, width=36, bands=bands, rank=8, missing=0.0, noise_sigma=0.0, seed=seed,
    )
    mask = matlab_strip_mask((36, 36))
    noisy = corrupt(base.clean, mask, noise_sigma=0.12, seed=seed)
    return HsiSample(noisy=noisy, mask=mask, clean=base.clean, name="matlab_twin")


def text_mask(
    shape: Tuple[int, int],
    text: str = "hello world",
    font_size: Optional[int] = None,
) -> np.ndarray:
    """Render text as missing pixels (0 where the glyphs are)."""
    from PIL import Image, ImageDraw, ImageFont

    h, w = shape
    img = Image.new("L", (w, h), 255)
    draw = ImageDraw.Draw(img)
    try:
        font = ImageFont.load_default(size=font_size) if font_size else ImageFont.load_default()
    except TypeError:  # older PIL without the size argument
        font = ImageFont.load_default()
    draw.text((1, h // 3), text, fill=0, font=font)
    return (np.asarray(img, dtype=np.float32) > 127).astype(np.float32)


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
