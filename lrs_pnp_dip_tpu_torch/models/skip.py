"""The `skip` hourglass — the flagship DIP network (counterpart of
``lrs_pnp_dip_tpu/models/skip.py``).

Per scale i (outermost to innermost):

    y = concat_center_crop( skip_i(x), deeper_i(x) )       # if skip ch > 0
    y = BN(y)
    y = act(BN(conv3x3(y)))                                # filter_size_up
    y = act(BN(conv1x1(y)))                                # if need1x1_up

with ``skip_i = act(BN(conv1x1(x)))`` and
``deeper_i = upsample2x([inner scales](act(BN(conv3x3(act(BN(conv3x3_stride2(x))))))))``;
head: conv1x1 -> sigmoid.

Submodules carry the names flax gives their counterparts (``Conv2d_<n>``,
``BatchNorm2d_<n>``, ``_SkipScale_0``, numbered per type in call order), so
a flax parameter tree maps onto the state dict by renaming alone
(:mod:`.transplant`).  The public layout is (N, H, W, C); the net runs NCHW
inside.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from .common import BatchNorm2d, Conv2d, activation, concat_center_crop, upsample2x


def _as_list(v, n):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


class _SkipScale(nn.Module):
    """One hourglass scale, containing the next scale recursively."""

    def __init__(
        self,
        depth: int,
        in_channels: int,
        n_scales: int,
        channels_down: Sequence[int],
        channels_up: Sequence[int],
        channels_skip: Sequence[int],
        filter_size_down: Sequence[int],
        filter_size_up: Sequence[int],
        filter_skip_size: int,
        pad: str,
        act_fun: str,
        upsample_mode: Sequence[str],
        downsample_mode: Sequence[str],
        need1x1_up: bool,
    ):
        super().__init__()
        i = depth
        self.act = activation(act_fun)
        self.upsample_mode = upsample_mode[i]
        counts = {"Conv2d": 0, "BatchNorm2d": 0}

        def add(module: nn.Module) -> str:
            kind = type(module).__name__
            name = f"{kind}_{counts[kind]}"
            counts[kind] += 1
            self.add_module(name, module)
            return name

        cd, cu, cs = channels_down[i], channels_up[i], channels_skip[i]
        self.down = [
            add(Conv2d(in_channels, cd, filter_size_down[i], stride=2, pad=pad,
                       downsample_mode=downsample_mode[i])),
            add(BatchNorm2d(cd)),
            add(Conv2d(cd, cd, filter_size_down[i], pad=pad)),
            add(BatchNorm2d(cd)),
        ]
        deeper_channels = cd
        self.inner = None
        if i < n_scales - 1:
            self.inner = "_SkipScale_0"
            self.add_module(self.inner, _SkipScale(
                i + 1, cd, n_scales, channels_down, channels_up, channels_skip,
                filter_size_down, filter_size_up, filter_skip_size, pad, act_fun,
                upsample_mode, downsample_mode, need1x1_up,
            ))
            deeper_channels = channels_up[i + 1]
        self.skip = None
        cat_channels = deeper_channels
        if cs > 0:
            self.skip = [
                add(Conv2d(in_channels, cs, filter_skip_size, pad=pad)),
                add(BatchNorm2d(cs)),
            ]
            cat_channels += cs
        self.post_bn = add(BatchNorm2d(cat_channels))
        self.up = [
            add(Conv2d(cat_channels, cu, filter_size_up[i], pad=pad)),
            add(BatchNorm2d(cu)),
        ]
        if need1x1_up:
            self.up += [add(Conv2d(cu, cu, 1, pad=pad)), add(BatchNorm2d(cu))]

    def _conv_bn_act(self, names, x):
        for conv, bn in zip(names[0::2], names[1::2]):
            x = self.act(getattr(self, bn)(getattr(self, conv)(x)))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self._conv_bn_act(self.down, x)
        if self.inner is not None:
            d = getattr(self, self.inner)(d)
        d = upsample2x(d, self.upsample_mode)
        if self.skip is not None:
            s = self._conv_bn_act(self.skip, x)
            y = concat_center_crop([s, d])
        else:
            y = d
        y = getattr(self, self.post_bn)(y)
        return self._conv_bn_act(self.up, y)


class Skip(nn.Module):
    """Encoder-decoder with per-scale skip branches (DIP 'skip' net).

    Takes and returns (N, H, W, C) tensors."""

    def __init__(
        self,
        num_input_channels: int,
        num_output_channels: int = 3,
        channels_down: Sequence[int] = (16, 32, 64, 128, 128),
        channels_up: Sequence[int] = (16, 32, 64, 128, 128),
        channels_skip: Sequence[int] = (4, 4, 4, 4, 4),
        filter_size_down: Union[int, Sequence[int]] = 3,
        filter_size_up: Union[int, Sequence[int]] = 3,
        filter_skip_size: int = 1,
        need_sigmoid: bool = True,
        pad: str = "zero",
        upsample_mode: Union[str, Sequence[str]] = "nearest",
        downsample_mode: Union[str, Sequence[str]] = "stride",
        act_fun: str = "LeakyReLU",
        need1x1_up: bool = True,
    ):
        super().__init__()
        n = len(channels_down)
        if not len(channels_up) == len(channels_skip) == n:
            raise ValueError("channels_down, channels_up and channels_skip differ in length")
        self.need_sigmoid = need_sigmoid
        self._SkipScale_0 = _SkipScale(
            0, num_input_channels, n, tuple(channels_down), tuple(channels_up),
            tuple(channels_skip), tuple(_as_list(filter_size_down, n)),
            tuple(_as_list(filter_size_up, n)), filter_skip_size, pad, act_fun,
            tuple(_as_list(upsample_mode, n)), tuple(_as_list(downsample_mode, n)),
            need1x1_up,
        )
        self.Conv2d_0 = Conv2d(channels_up[0], num_output_channels, 1, pad=pad)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter as a fresh net would (conv kernels from
        ``generator``, conv biases 0, BN scale 1 / bias 0)."""
        for mod in self.modules():
            if isinstance(mod, Conv2d):
                mod.reset_parameters(generator)
            elif isinstance(mod, BatchNorm2d):
                mod.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._SkipScale_0(x.permute(0, 3, 1, 2))
        y = self.Conv2d_0(y)
        if self.need_sigmoid:
            y = torch.sigmoid(y)
        return y.permute(0, 2, 3, 1)


def dip_skip_128(num_channels: int = 128) -> Skip:
    """The configuration the LRS-PnP-DIP main instantiates
    (reference ``main_LRS_PnP_DIP_pro.py:215-221``)."""
    return Skip(
        num_input_channels=num_channels,
        num_output_channels=num_channels,
        channels_down=(128,) * 5,
        channels_up=(128,) * 5,
        channels_skip=(128,) * 5,
        filter_size_down=3,
        filter_size_up=3,
        filter_skip_size=1,
        need_sigmoid=True,
        pad="reflection",
        upsample_mode="nearest",
        act_fun="LeakyReLU",
    )
