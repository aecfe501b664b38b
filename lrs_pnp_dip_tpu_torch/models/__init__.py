"""The DIP nets of the port and the string-keyed model factory
(counterpart of ``lrs_pnp_dip_tpu/models/__init__.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .common import BatchNorm2d, Conv2d, activation, concat_center_crop, pad_input, upsample2x
from .lipschitz import ConvOperatorNorm, SNBatchNorm2d, SNConv2d
from .lipschitz_unet import LipschitzUNet
from .skip import Skip, dip_skip_128
from .transplant import lipschitz_unet_params_from_flax, skip_params_from_flax

_UNPORTED_NETS = (
    "ResNet", "texture_nets", "UNet", "UNet3D", "deep_decoder", "res_decoder",
)


class Identity(nn.Module):
    """The ``'identity'`` net: returns its input; it has nothing to draw."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        pass

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def get_net(
    input_depth: int,
    net_type: str,
    pad: str = "zero",
    upsample_mode: str = "nearest",
    n_channels: int = 3,
    act_fun: str = "LeakyReLU",
    skip_n33d: int = 128,
    skip_n33u: int = 128,
    skip_n11: int = 4,
    num_scales: int = 5,
    downsample_mode: str = "stride",
):
    """String-keyed model factory with the DIP-standard defaults (reference
    ``models/__init__.py:8-32``).  ``'skip'``, ``'lipschitz_unet'`` and
    ``'identity'`` are ported; the other keys of the JAX package raise."""
    if net_type == "skip":
        as_list = lambda v: [v] * num_scales if isinstance(v, int) else v
        return Skip(
            num_input_channels=input_depth,
            num_output_channels=n_channels,
            channels_down=tuple(as_list(skip_n33d)),
            channels_up=tuple(as_list(skip_n33u)),
            channels_skip=tuple(as_list(skip_n11)),
            upsample_mode=upsample_mode,
            downsample_mode=downsample_mode,
            act_fun=act_fun,
            pad=pad,
            need_sigmoid=True,
            need1x1_up=True,
        )
    if net_type == "lipschitz_unet":
        return LipschitzUNet(input_depth, num_output_channels=n_channels, pad="reflection")
    if net_type == "identity":
        return Identity()
    if net_type in _UNPORTED_NETS:
        raise NotImplementedError(
            f"net_type={net_type!r} is not ported yet (ROADMAP Queue A, item 14)"
        )
    raise ValueError(f"unknown net_type {net_type!r}")


__all__ = [
    "BatchNorm2d",
    "Conv2d",
    "ConvOperatorNorm",
    "Identity",
    "LipschitzUNet",
    "SNBatchNorm2d",
    "SNConv2d",
    "Skip",
    "activation",
    "concat_center_crop",
    "dip_skip_128",
    "get_net",
    "lipschitz_unet_params_from_flax",
    "pad_input",
    "skip_params_from_flax",
    "upsample2x",
]
