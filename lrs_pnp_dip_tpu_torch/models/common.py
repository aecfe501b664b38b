"""Shared NN building blocks for the DIP nets (counterpart of
``lrs_pnp_dip_tpu/models/common.py``).

The modules run NCHW (NCDHW for 3-D) inside; the nets convert from the
public (N, H, W, C) layout at their boundary.  Semantics follow the JAX
package:

  * BatchNorm in training mode only: batch statistics over (N, H, W),
    biased variance, eps 1e-5, no running statistics;
  * ``(k-1)//2`` reflection, replication or zero padding, then a VALID
    convolution; downsampling by stride, or at stride 1 followed by an
    average or max pool or a Lanczos :class:`~.downsampler.Downsampler`;
  * nearest or bilinear x2 upsampling; center-crop concatenation.

Reflection padding folds its gradient back in a fixed order, and bilinear
upsampling is a fixed-weight sum of shifted slices, so that their backward,
and with it a DIP fit, repeats bit for bit on the card.

Initialisation matches the JAX package in distribution: conv kernels
U(+-1/sqrt(fan_in)) (``lrs_pnp_dip_tpu/models/common.py:31``), conv biases
ZERO (flax's ``nn.Conv`` default, not torch's), BN scale 1 and bias 0; a
plain flax ``nn.Conv`` or ``nn.Dense`` (:class:`Conv`, :class:`Dense`) draws
its kernel from flax's default LeCun normal.

Nets of the zoo derive from :class:`ZooModule`, which names submodules as
flax names their counterparts (``Conv2d_0``, ``BatchNorm2d_1``, ... numbered
per class in creation order), so a flax tree maps onto the state dict by
renaming (:func:`~.transplant.params_from_flax`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nlm import np_pad_index


def activation(name: str = "LeakyReLU") -> Callable[[torch.Tensor], torch.Tensor]:
    """'LeakyReLU' (slope 0.2) | 'Swish' | 'ELU' | 'none'."""
    if name == "LeakyReLU":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if name == "Swish":
        return lambda x: x * torch.sigmoid(x)
    if name == "ELU":
        return F.elu
    if name == "none":
        return lambda x: x
    raise ValueError(f"unknown activation {name!r}")


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None) -> None:
    """flax's default kernel init: a normal truncated at two deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class ZooModule(nn.Module):
    """A module whose submodules carry flax's auto-names."""

    def add(self, module: nn.Module) -> nn.Module:
        """Register ``module`` as ``<Class>_<n>``, n counting that class's
        submodules in creation order, as flax numbers them."""
        counts = self.__dict__.setdefault("_flax_counts", {})
        kind = type(module).__name__
        n = counts.get(kind, 0)
        counts[kind] = n + 1
        self.add_module(f"{kind}_{n}", module)
        return module

    def reset_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw the parameters this module holds itself (none here)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-draw every parameter as a fresh net would, kernels from
        ``generator``."""
        self.reset_own_parameters(generator)
        for child in self.children():
            if hasattr(child, "reset_parameters"):
                child.reset_parameters(generator)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Training-mode batch normalisation over all axes but the channels' (1)."""
    if x.numel() == x.shape[1]:
        # one value per channel (a 1x1 map of one image): torch's kernel
        # refuses it; x is its own mean and the variance is 0
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (x - x) / math.sqrt(eps) * weight.reshape(shape) + bias.reshape(shape)
    return F.batch_norm(x, None, None, weight, bias, training=True, eps=eps)


class BatchNorm2d(nn.Module):
    """Training-mode batch normalisation over all axes but the channels'."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(x, self.weight, self.bias, self.eps)


class MeanOnlyBatchNorm(nn.Module):
    """Subtract the batch mean per channel, add a learned bias (reference
    ``models/common_for_Lipschitz_Control.py`` MeanOnlyBatchNorm)."""

    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x - torch.mean(x, dim=axes, keepdim=True) + self.bias.reshape(shape)


def _reflected(g: torch.Tensor, axis: int, start: int, pad: int) -> torch.Tensor:
    """``pad`` entries of ``g`` along ``axis`` from ``start``, reversed (a
    single entry is its own reverse: no copy)."""
    part = g.narrow(axis, start, pad)
    return part if pad == 1 else part.flip(axis)


class _ReflectPad(torch.autograd.Function):
    """Reflection padding of every spatial axis longer than the pad: the
    forward is ``F.pad(mode="reflect")`` (a copy), and the backward folds the
    padded gradient back in a fixed order, each axis from the last: the
    centre, then the left pad, then the right pad added onto the entries
    they copied.  ``F.pad``'s own reflection backward sums with atomics on
    the card, so a DIP fit through it does not repeat."""

    @staticmethod
    def forward(ctx, x, pad):
        ctx.pad = pad
        return F.pad(x, (pad, pad) * (x.ndim - 2), mode="reflect")

    @staticmethod
    def backward(ctx, g):
        p = ctx.pad
        for axis in range(g.ndim - 1, 1, -1):
            n = g.shape[axis] - 2 * p
            out = g.narrow(axis, p, n).clone()
            out.narrow(axis, 1, p).add_(_reflected(g, axis, 0, p))
            out.narrow(axis, n - 1 - p, p).add_(_reflected(g, axis, n + p, p))
            g = out
        return g, None


def _reflect_short(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``np.pad(mode="reflect")`` of axes no longer than the pad too (a 1x1
    map repeats; torch's reflection refuses them), as slices and ``cat``:
    the backward adds each entry's copies in a fixed order."""
    for axis in range(2, x.ndim):
        index = np_pad_index(x.shape[axis], pad, "reflect", "cpu").tolist()
        x = torch.cat([x.narrow(axis, i, 1) for i in index], dim=axis)
    return x


def pad_input(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Spatial padding of an NCHW (or NCDHW) tensor."""
    if pad == 0:
        return x
    widths = (pad, pad) * (x.ndim - 2)
    if mode == "reflection":
        if min(x.shape[2:]) > pad:
            return _ReflectPad.apply(x, pad)
        return _reflect_short(x, pad)
    if mode == "replication":
        return F.pad(x, widths, mode="replicate")
    if mode == "zero":
        return F.pad(x, widths)
    raise ValueError(f"unknown pad mode {mode!r}")


class Conv2d(nn.Module):
    """``(k-1)//2`` padding in mode ``pad``, then a VALID convolution.
    ``downsample_mode`` 'stride' strides the conv; 'avg' and 'max' convolve
    at stride 1 and pool; 'lanczos2' and 'lanczos3' convolve at stride 1 and
    append a :class:`~.downsampler.Downsampler` (no parameters)."""

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
        self.pool = None
        self.factor = stride
        if stride != 1 and downsample_mode != "stride":
            if downsample_mode not in ("avg", "max", "lanczos2", "lanczos3"):
                raise ValueError(f"unknown downsample mode {downsample_mode!r}")
            self.pool, stride = downsample_mode, 1
            if downsample_mode.startswith("lanczos"):
                from .downsampler import Downsampler

                self.Downsampler_0 = Downsampler(
                    factor=self.factor, kernel_type=downsample_mode, phase=0.5, preserve_size=True
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
        x = F.conv2d(x, self.weight, self.bias, stride=self.stride)
        s = self.factor
        if self.pool == "avg":
            return F.avg_pool2d(x, s, s)
        if self.pool == "max":
            return F.max_pool2d(x, s, s)
        if self.pool is not None:
            return self.Downsampler_0(x)
        return x


class Conv(nn.Module):
    """A plain flax ``nn.Conv`` over NCDHW volumes (UNet3D's): 'SAME' zero
    padding (odd kernels), stride 1, kernel from flax's default LeCun normal,
    bias zero.  Weight (out, in, kd, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Sequence[int]):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding = tuple(k // 2 for k in self.weight.shape[2:])
        return F.conv3d(x, self.weight, self.bias, padding=padding)


class Dense(nn.Module):
    """flax ``nn.Dense``: weight (out, in) from LeCun normal, bias zero."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis (eps 1e-6, flax's default)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)


def _linear_up2(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x2 linear upsampling along one axis with half-pixel centres and the
    edge clamped: output 2i is 0.75 x[i] + 0.25 x[i-1], output 2i+1 is
    0.75 x[i] + 0.25 x[i+1] (``align_corners=False`` at a factor of 2).  A
    fixed-weight sum of shifted slices, so that the backward adds in a fixed
    order, where ``F.interpolate``'s linear backward sums with atomics on the
    card."""
    n = x.shape[axis]
    prev = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)
    nxt = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    even = 0.75 * x + 0.25 * prev
    odd = 0.75 * x + 0.25 * nxt
    return torch.stack([even, odd], dim=axis + 1).flatten(axis, axis + 1)


def upsample_linear2x(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear (NCHW) or trilinear (NCDHW) upsampling, one spatial axis
    after the other: ``jax.image.resize(method='bilinear' / 'trilinear')``,
    half-pixel centres with the edge taps renormalised, which at a factor of
    2 clamps the source index at the border (``tests/test_torch_zoo.py`` and
    ``tests/test_torch_lipschitz.py`` pin the two together)."""
    for axis in range(2, x.ndim):
        x = _linear_up2(x, axis)
    return x


def upsample2x(x: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    """x2 spatial upsampling of NCHW: 'nearest' (whose backward already
    gathers in a fixed order) or 'bilinear' (:func:`upsample_linear2x`)."""
    if mode == "nearest":
        return F.interpolate(x, scale_factor=2, mode="nearest")
    if mode == "bilinear":
        return upsample_linear2x(x)
    raise ValueError(f"unknown upsample mode {mode!r}")


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


class GenNoise(nn.Module):
    """A standard-normal tensor shaped like the NCHW input but with ``dim2``
    channels, drawn from ``generator`` (reference ``models/common.py:45-60``)."""

    def __init__(self, dim2: int):
        super().__init__()
        self.dim2 = dim2

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        shape = (x.shape[0], self.dim2) + tuple(x.shape[2:])
        return torch.randn(shape, generator=generator, dtype=x.dtype, device=x.device)
