"""Shared NN building blocks for the DIP nets (counterpart of
``lrs_pnp_dip_tpu/models/common.py``).

The modules run NCHW inside; the nets convert from the public (N, H, W, C)
layout at their boundary.  Semantics follow the JAX package:

  * BatchNorm in training mode only: batch statistics over (N, H, W),
    biased variance, eps 1e-5, no running statistics;
  * ``(k-1)//2`` reflection or zero padding, then a VALID convolution;
    ``stride`` downsampling only;
  * nearest x2 upsampling; center-crop concatenation.

Initialisation matches the JAX package in distribution: conv kernels
U(+-1/sqrt(fan_in)) (``lrs_pnp_dip_tpu/models/common.py:31``), conv biases
ZERO (flax's ``nn.Conv`` default, not torch's), BN scale 1 and bias 0.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def activation(name: str = "LeakyReLU") -> Callable[[torch.Tensor], torch.Tensor]:
    """'LeakyReLU' (slope 0.2), the activation of the ported nets."""
    if name == "LeakyReLU":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    raise NotImplementedError(
        f"activation {name!r} is not ported yet (ROADMAP Queue A, item 14)"
    )


class BatchNorm2d(nn.Module):
    """Training-mode batch normalisation over (N, H, W) per channel."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(
            x, None, None, self.weight, self.bias, training=True, eps=self.eps
        )


def pad_input(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Spatial padding of an NCHW tensor."""
    if pad == 0:
        return x
    widths = (pad, pad, pad, pad)
    if mode == "reflection":
        return F.pad(x, widths, mode="reflect")
    if mode == "zero":
        return F.pad(x, widths)
    raise ValueError(f"unknown pad mode {mode!r}")


class Conv2d(nn.Module):
    """``(k-1)//2`` padding in mode ``pad``, then a VALID strided conv."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        bias: bool = True,
        pad: str = "zero",
        downsample_mode: str = "stride",
    ):
        super().__init__()
        if stride != 1 and downsample_mode != "stride":
            raise NotImplementedError(
                f"downsample_mode={downsample_mode!r} is not ported yet "
                "(ROADMAP Queue A, item 14)"
            )
        self.stride = stride
        self.pad = pad
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in = self.weight.shape[1] * self.kernel_size * self.kernel_size
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_input(x, (self.kernel_size - 1) // 2, self.pad)
        return F.conv2d(x, self.weight, self.bias, stride=self.stride)


def upsample2x(x: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    """x2 spatial upsampling of NCHW."""
    if mode == "nearest":
        return F.interpolate(x, scale_factor=2, mode="nearest")
    raise NotImplementedError(
        f"upsample mode {mode!r} is not ported yet (ROADMAP Queue A, item 14)"
    )


def concat_center_crop(inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate NCHW tensors on channels after center-cropping to the
    smallest spatial size (reference ``Concat``, ``models/common.py:19-39``)."""
    th = min(t.shape[2] for t in inputs)
    tw = min(t.shape[3] for t in inputs)
    cropped = []
    for t in inputs:
        dh = (t.shape[2] - th) // 2
        dw = (t.shape[3] - tw) // 2
        cropped.append(t[:, :, dh : dh + th, dw : dw + tw])
    return torch.cat(cropped, dim=1)
