"""Volumetric 3-D U-Net, the ``'UNet3D'`` net (counterpart of
``lrs_pnp_dip_tpu/models/unet3d.py``; reference ``models/unet3D.py:32-192``):
the HSI cube taken as a (N, D, H, W, C) volume; 3x3x3 convs with inline
batch norm and ReLU, max-pool downs, trilinear x2 ups with center-cropped
skip concatenations.

It takes 5-D input only.  A DIP solve hands its net the (1, H, W, B) iterate,
so ``dip_net='UNet3D'`` fails at the first forward, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, ZooModule, batch_norm, upsample_linear2x


def max_pool3d_2(y: torch.Tensor) -> torch.Tensor:
    """``F.max_pool3d(y, 2, 2)`` of NCDHW (odd edges dropped) as the maximum
    over each window's 8 entries in (d, h, w) order, the first of equal
    maxima taking the gradient: the backward gathers in a fixed order, where
    ``max_pool3d``'s has no deterministic implementation on the card."""
    n, c, d, h, w = y.shape
    y = y[:, :, : d // 2 * 2, : h // 2 * 2, : w // 2 * 2]
    windows = y.reshape(n, c, d // 2, 2, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 6, 3, 5, 7)
    return windows.reshape(n, c, d // 2, h // 2, w // 2, 8).max(dim=-1).values


class _Conv3Block(ZooModule):
    """Two (3x3x3 conv, batch norm, ReLU); the norm's scale and bias are
    parameters of the block itself (``bn_scale_i``, ``bn_bias_i``), as in
    the flax module."""

    def __init__(self, in_channels: int, features: int, norm: bool = True):
        super().__init__()
        self.norm = norm
        self.convs = [self.add(Conv(cin, features, (3, 3, 3))) for cin in (in_channels, features)]
        if norm:
            for i in range(2):
                self.register_parameter(f"bn_scale_{i}", nn.Parameter(torch.ones(features)))
                self.register_parameter(f"bn_bias_{i}", nn.Parameter(torch.zeros(features)))

    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.norm:
            with torch.no_grad():
                for i in range(2):
                    getattr(self, f"bn_scale_{i}").fill_(1.0)
                    getattr(self, f"bn_bias_{i}").zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if self.norm:
                x = batch_norm(x, getattr(self, f"bn_scale_{i}"), getattr(self, f"bn_bias_{i}"), 1e-5)
            x = F.relu(x)
        return x


class UNet3D(ZooModule):
    def __init__(
        self,
        num_input_channels: int = 1,
        num_output_channels: int = 1,
        feature_scale: int = 4,
        need_sigmoid: bool = True,
    ):
        super().__init__()
        self.need_sigmoid = need_sigmoid
        f = [64 // feature_scale * s for s in (1, 2, 4, 8)]
        self.down = [self.add(_Conv3Block(cin, cout))
                     for cin, cout in zip([num_input_channels] + f[:3], f)]
        self.up = [self.add(_Conv3Block(f[i + 1] + f[i], f[i])) for i in (2, 1, 0)]
        self.head = (self.add(Conv(f[0], num_output_channels, (1, 1, 1))),)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 5:
            raise ValueError(
                f"UNet3D takes (N, D, H, W, C) volumes, got a {x.ndim}-D input of shape {tuple(x.shape)}"
            )
        y = x.permute(0, 4, 1, 2, 3)
        skips = []
        for level, block in enumerate(self.down):
            if level:
                y = max_pool3d_2(y)
            y = block(y)
            skips.append(y)
        for block, skip in zip(self.up, reversed(skips[:3])):
            y = upsample_linear2x(y)
            lo = [(y.shape[ax] - skip.shape[ax]) // 2 for ax in (2, 3, 4)]
            y = y[:, :, lo[0] : lo[0] + skip.shape[2], lo[1] : lo[1] + skip.shape[3],
                  lo[2] : lo[2] + skip.shape[4]]
            y = block(torch.cat([y, skip], dim=1))
        y = self.head[0](y)
        if self.need_sigmoid:
            y = torch.sigmoid(y)
        return y.permute(0, 2, 3, 4, 1)
