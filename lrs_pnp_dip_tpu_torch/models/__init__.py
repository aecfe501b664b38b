"""The DIP nets of the port and the string-keyed model factory
(counterpart of ``lrs_pnp_dip_tpu/models/__init__.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .attention import (
    MultiHeadAttention, PositionwiseFeedForward, scaled_dot_product_attention,
    sinusoid_position_encoding,
)
from .common import (
    BatchNorm2d, Conv, Conv2d, Dense, GenNoise, LayerNorm, MeanOnlyBatchNorm, activation,
    concat_center_crop, pad_input, upsample2x,
)
from .deep_decoder import DeepDecoder, ResDecoder
from .downsampler import Downsampler, get_kernel
from .lipschitz import ConvOperatorNorm, SNBatchNorm2d, SNConv2d
from .lipschitz_unet import LipschitzUNet
from .resnet import ResNet
from .skip import Skip, dip_skip_128
from .texture_nets import TextureNet
from .transplant import lipschitz_unet_params_from_flax, params_from_flax, skip_params_from_flax
from .unet import UNet
from .unet3d import UNet3D


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
    ``models/__init__.py:8-32``), with every key of the JAX package.
    ``input_depth`` is the net's input channel count (flax infers it at
    init; torch needs it at construction)."""
    if net_type == "ResNet":
        return ResNet(input_depth, num_output_channels=n_channels, num_blocks=10,
                      num_channels=16, act_fun=act_fun, pad=pad)
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
    if net_type == "texture_nets":
        return TextureNet(input_depth, num_output_channels=n_channels, pad=pad, act_fun=act_fun)
    if net_type == "UNet":
        return UNet(input_depth, num_output_channels=n_channels, feature_scale=4,
                    upsample_mode="bilinear", pad=pad, need_sigmoid=True)
    if net_type == "UNet3D":
        return UNet3D(input_depth, num_output_channels=n_channels)
    if net_type == "deep_decoder":
        return DeepDecoder(input_depth, num_output_channels=n_channels)
    if net_type == "res_decoder":
        return ResDecoder(input_depth, num_output_channels=n_channels)
    if net_type == "lipschitz_unet":
        return LipschitzUNet(input_depth, num_output_channels=n_channels, pad="reflection")
    if net_type == "identity":
        return Identity()
    raise ValueError(f"unknown net_type {net_type!r}")


#: Every key of :func:`get_net`.
NET_TYPES = (
    "ResNet", "skip", "texture_nets", "UNet", "UNet3D", "deep_decoder", "res_decoder",
    "lipschitz_unet", "identity",
)

__all__ = [
    "BatchNorm2d",
    "Conv",
    "Conv2d",
    "ConvOperatorNorm",
    "Dense",
    "DeepDecoder",
    "Downsampler",
    "GenNoise",
    "Identity",
    "LayerNorm",
    "LipschitzUNet",
    "MeanOnlyBatchNorm",
    "MultiHeadAttention",
    "NET_TYPES",
    "PositionwiseFeedForward",
    "ResDecoder",
    "ResNet",
    "SNBatchNorm2d",
    "SNConv2d",
    "Skip",
    "TextureNet",
    "UNet",
    "UNet3D",
    "activation",
    "concat_center_crop",
    "dip_skip_128",
    "get_kernel",
    "get_net",
    "lipschitz_unet_params_from_flax",
    "pad_input",
    "params_from_flax",
    "scaled_dot_product_attention",
    "sinusoid_position_encoding",
    "skip_params_from_flax",
    "upsample2x",
]
