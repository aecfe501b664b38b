"""Deep-decoder nets, the ``'deep_decoder'`` and ``'res_decoder'`` nets
(counterpart of ``lrs_pnp_dip_tpu/models/deep_decoder.py``; reference
``include/decoder.py:10-127``): per scale a 1x1 conv, x2 bilinear upsampling,
ReLU and BN; the residual variant's scales are 1x1-conv residual blocks.

Each of the five scales doubles the size, so an (N, H, W, C) input gives a
32H x 32W output: a small noise input, not an image, is what these nets
take.  Takes and returns (N, H, W, C) tensors.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .common import BatchNorm2d, Conv2d, ZooModule, upsample2x


class DeepDecoder(ZooModule):
    def __init__(
        self,
        num_input_channels: int,
        num_output_channels: int = 3,
        channels: Sequence[int] = (128, 128, 128, 128, 128),
        need_sigmoid: bool = True,
        upsample_first: bool = True,
    ):
        super().__init__()
        self.need_sigmoid = need_sigmoid
        self.upsample_first = upsample_first
        self.scales = []
        cin = num_input_channels
        for c in channels:
            self.scales.append((self.add(Conv2d(cin, c, 1)), self.add(BatchNorm2d(c))))
            cin = c
        self.head = (self.add(Conv2d(cin, num_output_channels, 1)),)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)
        for conv, bn in self.scales:
            y = upsample2x(conv(y), "bilinear") if self.upsample_first else conv(upsample2x(y, "bilinear"))
            y = bn(F.relu(y))
        y = self.head[0](y)
        if self.need_sigmoid:
            y = torch.sigmoid(y)
        return y.permute(0, 2, 3, 1)


class _ResBlock1x1(ZooModule):
    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.layers = tuple(
            self.add(m) for m in (Conv2d(in_channels, features, 1), BatchNorm2d(features),
                                  Conv2d(features, features, 1), BatchNorm2d(features))
        )
        # the projection of the input when the widths differ
        self.proj = (self.add(Conv2d(in_channels, features, 1)),) if in_channels != features else ()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1, bn1, conv2, bn2 = self.layers
        y = bn2(conv2(F.relu(bn1(conv1(x)))))
        for proj in self.proj:
            x = proj(x)
        return F.relu(x + y)


class ResDecoder(ZooModule):
    def __init__(
        self,
        num_input_channels: int,
        num_output_channels: int = 3,
        channels: Sequence[int] = (128, 128, 128, 128, 128),
        need_sigmoid: bool = True,
    ):
        super().__init__()
        self.need_sigmoid = need_sigmoid
        self.scales = []
        cin = num_input_channels
        for c in channels:
            self.scales.append((self.add(_ResBlock1x1(cin, c)), self.add(BatchNorm2d(c))))
            cin = c
        self.head = (self.add(Conv2d(cin, num_output_channels, 1)),)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)
        for block, bn in self.scales:
            y = bn(upsample2x(block(y), "bilinear"))
        y = self.head[0](y)
        if self.need_sigmoid:
            y = torch.sigmoid(y)
        return y.permute(0, 2, 3, 1)
