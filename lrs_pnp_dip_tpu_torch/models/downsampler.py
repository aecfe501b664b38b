"""Anti-aliased fixed-kernel downsampler (counterpart of
``lrs_pnp_dip_tpu/models/downsampler.py``; reference
``models/downsampler.py:5-135``): a strided depthwise convolution with a
fixed analytic kernel (lanczos2 / lanczos3, gauss by name, or box), phase 0
or 0.5, optionally replication-padded so that the output is the input size
over the factor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@functools.lru_cache(maxsize=None)
def get_kernel(factor: int, kernel_type: str, phase: float, kernel_width: int,
               support: int = 0, sigma: float = 0.0) -> np.ndarray:
    """Analytic resampling kernel, normalised to sum 1."""
    if phase not in (0.0, 0.5):
        raise ValueError(f"phase must be 0 or 0.5, got {phase}")
    if phase == 0.5 and kernel_type != "box":
        kernel = np.zeros((kernel_width - 1, kernel_width - 1))
    else:
        kernel = np.zeros((kernel_width, kernel_width))

    if kernel_type == "box":
        if phase != 0.5:
            raise ValueError("the box kernel takes phase 0.5")
        kernel[:] = 1.0 / (kernel_width * kernel_width)
        return kernel

    center = (kernel_width + 1) / 2.0
    for i in range(1, kernel.shape[0] + 1):
        for j in range(1, kernel.shape[1] + 1):
            if phase == 0.5:
                di = abs(i + 0.5 - center) / factor
                dj = abs(j + 0.5 - center) / factor
            else:
                di = abs(i - center) / factor
                dj = abs(j - center) / factor
            if kernel_type == "gauss":
                val = np.exp(-(di * di + dj * dj) / (2 * sigma * sigma))
                val /= 2.0 * np.pi * sigma * sigma
            elif kernel_type == "lanczos":
                val = 1.0
                for d in (di, dj):
                    if d != 0:
                        pd = np.pi * d
                        val *= support * np.sin(pd) * np.sin(pd / support) / (pd * pd)
            else:
                raise ValueError(kernel_type)
            kernel[i - 1, j - 1] = val
    return kernel / kernel.sum()


def _resolve(kernel_type: str, factor: int):
    if kernel_type == "lanczos2":
        return "lanczos", 2, 4 * factor + 1, 0.0
    if kernel_type == "lanczos3":
        return "lanczos", 3, 6 * factor + 1, 0.0
    if kernel_type == "gauss12":
        return "gauss", 0, 7, 1.0 / 2.0
    if kernel_type == "gauss1sq2":
        return "gauss", 0, 9, 1.0 / np.sqrt(2.0)
    if kernel_type == "box":
        return "box", 0, factor, 0.0
    raise ValueError(kernel_type)


class Downsampler(nn.Module):
    """Depthwise strided convolution of NCHW with the fixed kernel; with
    ``preserve_size`` the input is replication-padded first (``(k-1)/2`` on
    both sides for an odd kernel, ``(k-factor)/2`` and one more after it for
    an even one).  Holds no parameters."""

    def __init__(self, factor: int = 2, kernel_type: str = "lanczos2", phase: float = 0.5,
                 preserve_size: bool = False):
        super().__init__()
        self.factor = factor
        self.preserve_size = preserve_size
        base, support, width, sigma = _resolve(kernel_type, factor)
        k = get_kernel(factor, base, phase, width, support, sigma)
        self.register_buffer("kernel", torch.tensor(k, dtype=torch.float32), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.shape[0]
        if self.preserve_size:
            if k % 2 == 1:
                lo = hi = (k - 1) // 2
            else:
                lo = (k - self.factor) // 2
                hi = lo + 1
            x = F.pad(x, (lo, hi, lo, hi), mode="replicate")
        c = x.shape[1]
        weight = self.kernel.to(x.dtype).expand(c, 1, k, k)
        return F.conv2d(x, weight, stride=self.factor, groups=c)
