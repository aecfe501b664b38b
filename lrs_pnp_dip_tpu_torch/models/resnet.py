"""The ``'ResNet'`` DIP net (counterpart of ``lrs_pnp_dip_tpu/models/resnet.py``;
reference ``models/resnet.py:9-97``): a conv + act stem, residual blocks
(conv-BN-act-conv-BN with a center-cropped residual add), a conv + BN tail,
a 1x1 conv and a sigmoid head.  Takes and returns (N, H, W, C) tensors."""

from __future__ import annotations

import torch

from .common import BatchNorm2d, Conv2d, ZooModule, activation


class _ResidualBlock(ZooModule):
    def __init__(self, features: int, act_fun: str, pad: str):
        super().__init__()
        self.act = activation(act_fun)
        self.layers = tuple(
            self.add(m) for m in (Conv2d(features, features, 3, pad=pad), BatchNorm2d(features),
                                  Conv2d(features, features, 3, pad=pad), BatchNorm2d(features))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1, bn1, conv2, bn2 = self.layers
        y = bn2(conv2(self.act(bn1(conv1(x)))))
        # center-crop residual add (reference ResidualSequential.forward)
        dh = (x.shape[2] - y.shape[2]) // 2
        dw = (x.shape[3] - y.shape[3]) // 2
        return x[:, :, dh : dh + y.shape[2], dw : dw + y.shape[3]] + y


class ResNet(ZooModule):
    def __init__(
        self,
        num_input_channels: int,
        num_output_channels: int = 3,
        num_blocks: int = 8,
        num_channels: int = 32,
        act_fun: str = "LeakyReLU",
        need_sigmoid: bool = True,
        pad: str = "reflection",
    ):
        super().__init__()
        self.act = activation(act_fun)
        self.need_sigmoid = need_sigmoid
        self.stem = (self.add(Conv2d(num_input_channels, num_channels, 3, pad=pad)),)
        self.blocks = [self.add(_ResidualBlock(num_channels, act_fun, pad)) for _ in range(num_blocks)]
        self.tail = tuple(
            self.add(m) for m in (Conv2d(num_channels, num_channels, 3, pad=pad), BatchNorm2d(num_channels),
                                  Conv2d(num_channels, num_output_channels, 1, pad=pad))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.stem[0](x.permute(0, 3, 1, 2)))
        for block in self.blocks:
            y = block(y)
        conv, bn, head = self.tail
        y = head(bn(conv(y)))
        if self.need_sigmoid:
            y = torch.sigmoid(y)
        return y.permute(0, 2, 3, 1)
