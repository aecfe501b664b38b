"""The 1-Lipschitz-constrained DIP network of the `dip_1lip` variant
(counterpart of ``lrs_pnp_dip_tpu/models/lipschitz_unet.py``; reference
``models/my_Lipschitz_Unet.py:21-148``): a 4-down / 4-up stack without
skips, every conv spectrally normalised and every batch norm max-abs
normalised:

  d1..d4:  SNconv3x3 stride 2 -> SNBN -> LReLU -> SNconv3x3 -> SNBN -> LReLU
  up1,up2: nearest x2 -> SNconv2x2 -> SNBN -> LReLU
  up3,up4: nearest x2 -> SNconv3x3 -> SNBN -> LReLU
  head:    SNconv1x1 -> SNBN -> LReLU -> SNconv1x1 -> LReLU

The conv2x2 layers run unpadded ((k-1)//2 = 0), so at the reference size the
spatial sizes go 36 -> 18 -> 9 -> 5 -> 3 -> 6->5 -> 10->9 -> 18 -> 36.  At
another size an up stage that misses the size recorded on the way down is
resized to it, sampling at ``floor((i + 0.5) * in / out)``: the rule of
``jax.image.resize(method='nearest')``, which in torch is
``mode='nearest-exact'`` (plain ``'nearest'`` samples at
``floor(i * in / out)`` and differs, for example in two of six indices of a
5 -> 6 resize).  At 36x36 no resize runs.

Each forward first takes the factors of all 14 convs in one call
(:func:`.lipschitz.conv_factors`: on the card one kernel launch for every
power iteration), then runs the layers, each conv dividing its weight by its
factor.

Submodules carry the names flax gives their counterparts (``SNConv2d_<n>``,
``SNBatchNorm2d_<n>``, numbered per type in call order), so a flax tree maps
onto the state dict by renaming (:mod:`.transplant`).  Takes and returns
(N, H, W, C) tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import activation, upsample2x
from .lipschitz import SNBatchNorm2d, SNConv2d, conv_factors


class LipschitzUNet(nn.Module):
    def __init__(
        self,
        num_input_channels: int,
        num_output_channels: int = 128,
        width: int = 128,
        ln_lambda: float = 1.0,
        pad: str = "reflection",
        act_fun: str = "LeakyReLU",
        sn_mode: str = "power",
    ):
        super().__init__()
        self.act = activation(act_fun)

        def conv(i, cin, cout, k, stride=1):
            self.add_module(f"SNConv2d_{i}", SNConv2d(
                cin, cout, kernel_size=k, stride=stride, ln_lambda=ln_lambda,
                pad=pad, sn_mode=sn_mode,
            ))

        cin = num_input_channels
        for d in range(4):
            conv(2 * d, cin, width, 3, stride=2)
            conv(2 * d + 1, width, width, 3)
            cin = width
        for j, k in enumerate((2, 2, 3, 3)):
            conv(8 + j, width, width, k)
        conv(12, width, width, 1)
        conv(13, width, num_output_channels, 1)
        for i in range(13):
            self.add_module(f"SNBatchNorm2d_{i}", SNBatchNorm2d(width))

    @property
    def power_products(self) -> int:
        """Matrix-vector products the spectral norms run per forward, summed
        over the convolutions (238 at the `dip_1lip` preset: 14 x (2 x 8 +
        1)); each comes with one two-norm.  A counter of
        :mod:`..utils.profiling`."""
        return sum(m.power_products for m in self.modules() if isinstance(m, SNConv2d))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter and every power-iteration vector as a
        fresh net would (conv kernels and ``u`` from ``generator``, conv
        biases 0, BN scale 1 / bias 0)."""
        for mod in self.modules():
            if isinstance(mod, SNConv2d):
                mod.reset_parameters(generator)
            elif isinstance(mod, SNBatchNorm2d):
                mod.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = [getattr(self, f"SNConv2d_{i}") for i in range(14)]
        weights = [conv.weight for conv in convs]  # read once: a parametrization computes it per read
        factors = conv_factors(convs, weights)
        return self.layers(x, lambda i, y: convs[i](y, weights[i], factors[i]))

    def layers(self, x: torch.Tensor, conv: Callable[[int, torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """The net on ``x`` with ``conv(i, y)`` as its conv ``i``: the forward
        passes each conv the factor it took for the group; with
        ``self.SNConv2d_<i>(y)`` each conv takes its own."""

        def conv_bn_act(i: int, y: torch.Tensor) -> torch.Tensor:
            return self.act(getattr(self, f"SNBatchNorm2d_{i}")(conv(i, y)))

        y = x.permute(0, 3, 1, 2)
        down_sizes = []
        for d in range(4):
            down_sizes.append(tuple(y.shape[2:]))
            y = conv_bn_act(2 * d + 1, conv_bn_act(2 * d, y))
        for j, target in enumerate(reversed(down_sizes)):
            y = conv_bn_act(8 + j, upsample2x(y, "nearest"))
            if tuple(y.shape[2:]) != target:
                y = F.interpolate(y, size=target, mode="nearest-exact")
        y = conv_bn_act(12, y)
        y = self.act(conv(13, y))
        return y.permute(0, 2, 3, 1)
