"""SSIM (counterpart of ``lrs_pnp_dip_tpu/ops/ssim.py``).

:func:`ssim` has the vendored pytorch_ssim semantics: 11x11 gaussian window
(sigma 1.5, normalised), 'same' filtering with ZERO padding, C1 = 0.01^2,
C2 = 0.03^2, mean over the full SSIM map (``pytorch_ssim/__init__.py:7-73``).
The window is separable, so the filter is two banded-matrix contractions, as
in the JAX package.  :func:`ssim_matlab` is the MATLAB twin's index.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2))
    g = g / g.sum()
    return np.asarray(np.outer(g, g), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _band_matrix(n: int, window_size: int, sigma: float = 1.5) -> np.ndarray:
    """(n, n) banded Toeplitz matrix of the zero-padded 'same' 1-D gaussian."""
    x = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2))
    g = g / g.sum()
    pad = window_size // 2
    W = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        lo = max(0, i - pad)
        hi = min(n, i + pad + 1)
        W[i, lo:hi] = g[lo - (i - pad) : hi - (i - pad)]
    return W


@functools.lru_cache(maxsize=64)
def _band_tensor(n: int, window_size: int, device: torch.device) -> torch.Tensor:
    """:func:`_band_matrix` on ``device``, copied there once: a captured
    graph cannot hold a copy from host memory."""
    return torch.from_numpy(_band_matrix(n, window_size)).to(device)


def _gaussian_filter(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(N, H, W, C) zero-padded 'same' gaussian filtering."""
    wh = _band_tensor(x.shape[1], window_size, x.device)
    ww = _band_tensor(x.shape[2], window_size, x.device)
    y = torch.einsum("hj,njwc->nhwc", wh, x)
    return torch.einsum("wk,nhkc->nhwc", ww, y)


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    size_average: bool = True,
) -> torch.Tensor:
    """SSIM of two (H, W, B) cubes or (N, H, W, B) batches."""
    if img1.ndim == 3:
        img1 = img1[None]
        img2 = img2[None]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-1)
    f = _gaussian_filter(stacked, window_size)
    mu1, mu2, s11, s22, s12 = torch.chunk(f, 5, dim=-1)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = s11 - mu1_sq
    sigma2_sq = s22 - mu2_sq
    sigma12 = s12 - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(1, 2, 3))


def ssim_matlab(
    img1: torch.Tensor,
    img2: torch.Tensor,
    border: tuple = (0, 0),
    L: float = 255.0,
    window_size: int = 11,
) -> torch.Tensor:
    """The MATLAB twin's SSIM (``cal_ssim.m`` over Zhou Wang's
    ``ssim_index``): optional border crop, VALID (un-padded) gaussian
    filtering, dynamic range ``L``, the per-channel indices summed and
    divided by 3 whatever the channel count (kept as the reference has it).
    A single channel returns the plain index.

    Inputs: (H, W) or (H, W, C) cubes.
    """
    if img1.ndim == 2:
        img1 = img1[..., None]
        img2 = img2[..., None]
    b_row, b_col = border
    h, w, _ = img1.shape
    crop = (slice(b_row, h - b_row if b_row else h), slice(b_col, w - b_col if b_col else w))
    img1, img2 = img1[crop], img2[crop]
    c = img1.shape[-1]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-1)
    w2d = torch.from_numpy(_gaussian_window(window_size)).to(stacked.device)
    kernel = w2d.expand(5 * c, 1, window_size, window_size)
    f = F.conv2d(stacked.permute(2, 0, 1)[None], kernel, groups=5 * c)[0].permute(1, 2, 0)
    mu1, mu2 = f[..., :c], f[..., c : 2 * c]
    s11 = f[..., 2 * c : 3 * c] - mu1 * mu1
    s22 = f[..., 3 * c : 4 * c] - mu2 * mu2
    s12 = f[..., 4 * c :] - mu1 * mu2
    C1, C2 = (0.01 * L) ** 2, (0.03 * L) ** 2
    smap = ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / (
        (mu1 * mu1 + mu2 * mu2 + C1) * (s11 + s22 + C2)
    )
    per_channel = torch.mean(smap, dim=(0, 1))
    if c == 1:
        return per_channel[0]
    return torch.sum(per_channel) / 3.0
