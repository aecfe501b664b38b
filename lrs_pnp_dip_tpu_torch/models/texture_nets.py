"""The texture-nets multi-scale generator, the ``'texture_nets'`` net
(counterpart of ``lrs_pnp_dip_tpu/models/texture_nets.py``; reference
``models/texture_nets.py:17-79``): for each downsampling ratio (default
32, 16, 8, 4, 2, 1, coarsest first) an average-pooled copy of the input goes
through three conv + BN + act stacks (3x3, 3x3, 1x1); the scales merge
coarsest to finest by BN, center-cropped concat, three more stacks and x2
nearest upsampling; a 1x1 conv and a sigmoid head.

The pools floor, so at 36x36 the output is 32x32.  Takes and returns
(N, H, W, C) tensors.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .common import BatchNorm2d, Conv2d, ZooModule, activation, concat_center_crop, upsample2x


class TextureNet(ZooModule):
    def __init__(
        self,
        num_input_channels: int,
        num_output_channels: int = 3,
        ratios: Sequence[int] = (32, 16, 8, 4, 2, 1),
        pad: str = "zero",
        need_sigmoid: bool = True,
        conv_num: int = 8,
        act_fun: str = "LeakyReLU",
    ):
        super().__init__()
        self.act = activation(act_fun)
        self.ratios = tuple(ratios)
        self.need_sigmoid = need_sigmoid
        c = conv_num

        def stacks(cin):  # (conv, bn) pairs of the 3x3, 3x3, 1x1 stacks
            return [(self.add(Conv2d(ci, c, k, pad=pad)), self.add(BatchNorm2d(c)))
                    for ci, k in ((cin, 3), (c, 3), (c, 1))]

        # flax creates the modules in call order: per ratio the branch's
        # stacks, then (after the first) the two merge BNs and the merge stacks
        self.scales = []
        for i in range(len(self.ratios)):
            branch = stacks(num_input_channels)
            merge = None
            if i:
                merge = (self.add(BatchNorm2d(c)), self.add(BatchNorm2d(c)), stacks(2 * c))
            self.scales.append((branch, merge))
        self.head = (self.add(Conv2d(c, num_output_channels, 1, pad=pad)),)

    def _run(self, layers, y):
        for conv, bn in layers:
            y = self.act(bn(conv(y)))
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        merged = None
        for ratio, (branch, merge) in zip(self.ratios, self.scales):
            inp = F.avg_pool2d(x, ratio, ratio) if ratio > 1 else x
            y = self._run(branch, inp)
            if merge is None:
                merged = y
            else:
                bn_merged, bn_branch, layers = merge
                merged = self._run(layers, concat_center_crop([bn_merged(merged), bn_branch(y)]))
            if ratio > 1:
                merged = upsample2x(merged, "nearest")
        y = self.head[0](merged)
        if self.need_sigmoid:
            y = torch.sigmoid(y)
        return y.permute(0, 2, 3, 1)
