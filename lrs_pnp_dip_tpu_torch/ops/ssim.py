"""SSIM with the vendored pytorch_ssim semantics (counterpart of
``lrs_pnp_dip_tpu/ops/ssim.py:ssim``).

11x11 gaussian window (sigma 1.5, normalised), 'same' filtering with ZERO
padding, C1 = 0.01^2, C2 = 0.03^2, mean over the full SSIM map
(``pytorch_ssim/__init__.py:7-73``).  The window is separable, so the
filter is two banded-matrix contractions, as in the JAX package.
``ssim_matlab`` is not ported yet (ROADMAP Queue A, item 13).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


def _gaussian_filter(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(N, H, W, C) zero-padded 'same' gaussian filtering."""
    wh = torch.from_numpy(_band_matrix(x.shape[1], window_size)).to(x.device)
    ww = torch.from_numpy(_band_matrix(x.shape[2], window_size)).to(x.device)
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
