"""Classic U-Net with skip concatenations, the ``'UNet'`` net (counterpart of
``lrs_pnp_dip_tpu/models/unet.py``; reference ``models/unet.py:32-201``):
4 down / 4 up scales with filter counts [64, 128, 256, 512, 1024] divided by
``feature_scale``, an optional input pyramid concatenated at every scale
(``concat_x``; the first scale takes the input twice, as in the JAX
package), the up path by x2 upsampling and a conv, a sigmoid head.

Max pooling floors odd sizes, so at 36x36 the output is 32x32.  Takes and
returns (N, H, W, C) tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import BatchNorm2d, Conv2d, ZooModule, concat_center_crop, upsample2x


class _UnetConv2(ZooModule):
    def __init__(self, in_channels: int, features: int, norm: bool = True, pad: str = "zero"):
        super().__init__()
        self.layers = []
        for cin in (in_channels, features):
            conv = self.add(Conv2d(cin, features, 3, pad=pad))
            self.layers.append((conv, self.add(BatchNorm2d(features)) if norm else None))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in self.layers:
            x = conv(x)
            if bn is not None:
                x = bn(x)
            x = F.relu(x)
        return x


class _UnetUp(ZooModule):
    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 upsample_mode: str = "bilinear", pad: str = "zero"):
        super().__init__()
        self.upsample_mode = upsample_mode
        self.parts = (
            self.add(Conv2d(in_channels, features, 3, pad=pad)),
            self.add(_UnetConv2(features + skip_channels, features, pad=pad)),
        )

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        conv, block = self.parts
        return block(concat_center_crop([conv(upsample2x(x, self.upsample_mode)), skip]))


class UNet(ZooModule):
    def __init__(
        self,
        num_input_channels: int,
        num_output_channels: int = 3,
        feature_scale: int = 4,
        upsample_mode: str = "bilinear",
        pad: str = "zero",
        norm: bool = True,
        need_sigmoid: bool = True,
        concat_x: bool = False,
    ):
        super().__init__()
        self.need_sigmoid = need_sigmoid
        self.concat_x = concat_x
        f = [64 // feature_scale * s for s in (1, 2, 4, 8, 16)]
        extra = num_input_channels if concat_x else 0
        self.down = [
            self.add(_UnetConv2(cin + extra, cout, norm, pad))
            for cin, cout in zip([num_input_channels] + f[:4], f)
        ]
        self.up = [self.add(_UnetUp(f[i + 1], f[i], f[i], upsample_mode, pad)) for i in (3, 2, 1, 0)]
        self.head = (self.add(Conv2d(f[0], num_output_channels, 1, pad=pad)),)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        pyramid = [x]
        if self.concat_x:
            for _ in range(4):
                pyramid.append(F.avg_pool2d(pyramid[-1], 2, 2))
        skips = []
        y = x
        for level, block in enumerate(self.down):
            if level:
                y = F.max_pool2d(y, 2, 2)
            if self.concat_x:  # the input itself at the first level too
                y = concat_center_crop([y, pyramid[level]])
            y = block(y)
            skips.append(y)
        for block, skip in zip(self.up, reversed(skips[:4])):
            y = block(y, skip)
        y = self.head[0](y)
        if self.need_sigmoid:
            y = torch.sigmoid(y)
        return y.permute(0, 2, 3, 1)
