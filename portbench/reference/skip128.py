"""The DIP net of LRS-PnP-DIP, skip-128, in plain PyTorch.

As the reference instantiates it (``main_LRS_PnP_DIP_pro.py:215-221``, the
``skip`` hourglass of Ulyanov et al.'s Deep Image Prior code): five scales of
128 channels down, up and skip, 3x3 filters down and up, 1x1 skip filters,
reflection padding, stride-2 downsampling, nearest x2 upsampling, LeakyReLU
(slope 0.2), batch norm in training mode (batch statistics, biased variance,
eps 1e-5), a 1x1 conv and a sigmoid at the head.  Per scale, outermost first:

    d = act(BN(conv3x3(act(BN(conv3x3_s2(x))))))
    d = up2(inner(d))                    (innermost scale: up2(d))
    s = act(BN(conv1x1(x)))
    y = BN(concat(crop(s), crop(d)))
    y = act(BN(conv1x1(act(BN(conv3x3(y))))))

Parameters live in a flat dict keyed by the names the program's net gives
them (flax's auto-names, ``<Class>_<n>`` per module class in creation order),
so one dict of initial weights serves both.  NCHW throughout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

N_SCALES = 5
WIDTH = 128


def param_spec(channels: int, width: int = WIDTH, n_scales: int = N_SCALES) -> list:
    """``[(name, shape, kind)]`` of every parameter, ``kind`` one of
    ``conv_w`` (drawn U(+-1/sqrt(fan_in))), ``conv_b`` (zero), ``bn_w`` (one),
    ``bn_b`` (zero)."""
    spec = []

    def conv(prefix, n, cin, cout, k):
        spec.append((f"{prefix}Conv2d_{n}.weight", (cout, cin, k, k), "conv_w"))
        spec.append((f"{prefix}Conv2d_{n}.bias", (cout,), "conv_b"))

    def bn(prefix, n, c):
        spec.append((f"{prefix}BatchNorm2d_{n}.weight", (c,), "bn_w"))
        spec.append((f"{prefix}BatchNorm2d_{n}.bias", (c,), "bn_b"))

    cin = channels
    for i in range(n_scales):
        p = "_SkipScale_0." * (i + 1)
        conv(p, 0, cin, width, 3)
        bn(p, 0, width)
        conv(p, 1, width, width, 3)
        bn(p, 1, width)
        conv(p, 2, cin, width, 1)
        bn(p, 2, width)
        bn(p, 3, 2 * width)
        conv(p, 3, 2 * width, width, 3)
        bn(p, 4, width)
        conv(p, 4, width, width, 1)
        bn(p, 5, width)
        cin = width
    conv("", 0, width, channels, 1)
    return spec


def init_params(spec: list, generator: torch.Generator, device) -> dict:
    """One draw of every parameter from ``generator``: all conv kernels from
    a single ``torch.rand`` call on ``device``, scaled per kernel."""
    n = sum(math.prod(shape) for _, shape, kind in spec if kind == "conv_w")
    u = torch.rand(n, generator=generator, device=device, dtype=torch.float32)
    params, at = {}, 0
    for name, shape, kind in spec:
        if kind == "conv_w":
            size = math.prod(shape)
            bound = 1.0 / math.sqrt(shape[1] * shape[2] * shape[3])
            params[name] = (u[at : at + size].reshape(shape) * 2.0 - 1.0) * bound
            at += size
        elif kind == "bn_w":
            params[name] = torch.ones(shape, device=device)
        else:
            params[name] = torch.zeros(shape, device=device)
    return params


def _reflect1(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Reflection padding by one along ``axis`` (``np.pad(mode='reflect')``:
    a length-1 axis repeats its entry)."""
    n = x.shape[axis]
    if n == 1:
        return torch.cat([x, x, x], dim=axis)
    return torch.cat([x.narrow(axis, 1, 1), x, x.narrow(axis, n - 2, 1)], dim=axis)


def conv(params: dict, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    w = params[name + ".weight"]
    if w.shape[-1] == 3:
        x = _reflect1(_reflect1(x, 2), 3)
    return F.conv2d(x, w, params[name + ".bias"], stride=stride)


def bn(params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    if x.numel() == x.shape[1]:  # one value per channel: its own mean, variance 0
        w, b = params[name + ".weight"], params[name + ".bias"]
        return (x - x) / math.sqrt(1e-5) * w.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1)
    return F.batch_norm(x, None, None, params[name + ".weight"], params[name + ".bias"],
                        training=True, eps=1e-5)


def act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def crop_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    dh, dw = (x.shape[2] - h) // 2, (x.shape[3] - w) // 2
    return x[:, :, dh : dh + h, dw : dw + w]


def _scale(params: dict, i: int, x: torch.Tensor, n_scales: int) -> torch.Tensor:
    p = "_SkipScale_0." * (i + 1)
    d = act(bn(params, p + "BatchNorm2d_0", conv(params, p + "Conv2d_0", x, stride=2)))
    d = act(bn(params, p + "BatchNorm2d_1", conv(params, p + "Conv2d_1", d)))
    if i < n_scales - 1:
        d = _scale(params, i + 1, d, n_scales)
    d = up2(d)
    s = act(bn(params, p + "BatchNorm2d_2", conv(params, p + "Conv2d_2", x)))
    h, w = min(s.shape[2], d.shape[2]), min(s.shape[3], d.shape[3])
    y = bn(params, p + "BatchNorm2d_3", torch.cat([crop_to(s, h, w), crop_to(d, h, w)], dim=1))
    y = act(bn(params, p + "BatchNorm2d_4", conv(params, p + "Conv2d_3", y)))
    return act(bn(params, p + "BatchNorm2d_5", conv(params, p + "Conv2d_4", y)))


def forward(params: dict, x: torch.Tensor, n_scales: int = N_SCALES) -> torch.Tensor:
    """The net on an NCHW input; returns NCHW in (0, 1)."""
    return torch.sigmoid(conv(params, "Conv2d_0", _scale(params, 0, x, n_scales)))


def _out(n: int, stride: int) -> int:
    """Output length of a 3x3 conv with reflection padding 1 at ``stride``."""
    return (n + 2 - 3) // stride + 1


def conv_layers(height: int, width: int, channels: int, width_ch: int = WIDTH,
                n_scales: int = N_SCALES) -> list:
    """Every convolution of one forward pass as ``(name, cin, cout, k, h_out,
    w_out, input_needs_grad)``, from the shapes alone."""
    layers = []

    def scale(i, cin, h, w, input_grad):
        p = "_SkipScale_0." * (i + 1)
        hd, wd = _out(h, 2), _out(w, 2)
        layers.append((p + "Conv2d_0", cin, width_ch, 3, hd, wd, input_grad))
        layers.append((p + "Conv2d_1", width_ch, width_ch, 3, hd, wd, True))
        if i < n_scales - 1:
            hd, wd = scale(i + 1, width_ch, hd, wd, True)
        hu, wu = 2 * hd, 2 * wd
        layers.append((p + "Conv2d_2", cin, width_ch, 1, h, w, input_grad))
        hc, wc = min(h, hu), min(w, wu)
        layers.append((p + "Conv2d_3", 2 * width_ch, width_ch, 3, hc, wc, True))
        layers.append((p + "Conv2d_4", width_ch, width_ch, 1, hc, wc, True))
        return hc, wc

    h, w = scale(0, channels, height, width, False)
    layers.append(("Conv2d_0", width_ch, channels, 1, h, w, True))
    return layers


def fit_flops_per_iteration(height: int, width: int, channels: int) -> int:
    """Floating-point operations of the convolutions of one DIP iteration:
    the forward pass, the weight gradients, and the input gradients of every
    convolution whose input needs one (not the two that read the net's
    input).  A multiply-add counts as two.  Batch norm, activations, the
    loss and Adam (elementwise) are not counted."""
    total = 0
    for _, cin, cout, k, ho, wo, input_grad in conv_layers(height, width, channels):
        macs = cin * cout * k * k * ho * wo
        total += 2 * macs * (3 if input_grad else 2)
    return total

