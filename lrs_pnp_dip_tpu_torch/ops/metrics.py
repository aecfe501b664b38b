"""Image-quality metrics (counterpart of ``lrs_pnp_dip_tpu/ops/metrics.py``).

The reference PSNR is deliberately non-standard, ``10 log10(255 / sqrt(mse))``
on [0, 1]-ranged data (``main_LRS_PnP_DIP_pro.py:54-60``); it is kept
exactly so MPSNR numbers compare with the JAX package and the reference.
A standard PSNR is provided alongside.
"""

from __future__ import annotations

import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Reference-compatible PSNR: 10*log10(255 / sqrt(mse))."""
    return 10.0 * torch.log10(255.0 / torch.sqrt(mse(a, b)))


def psnr_standard(a: torch.Tensor, b: torch.Tensor, peak: float = 1.0) -> torch.Tensor:
    """Conventional PSNR = 10*log10(peak^2 / mse)."""
    return 10.0 * torch.log10(peak * peak / mse(a, b))


def mpsnr(clean: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Mean over spectral bands of per-band reference PSNR of (H, W, B) cubes."""
    m = torch.mean((clean - pred) ** 2, dim=(0, 1))  # per band
    return torch.mean(10.0 * torch.log10(255.0 / torch.sqrt(m)))


def batch_mpsnr(clean: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Mean MPSNR over a leading batch axis of (N, H, W, B) cubes."""
    m = torch.mean((clean - pred) ** 2, dim=(1, 2))  # (N, B)
    return torch.mean(10.0 * torch.log10(255.0 / torch.sqrt(m)))
