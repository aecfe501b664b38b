"""The DIP net of LRS-PnP-DIP(1-Lip), the Lipschitz U-Net, and its fit, in
plain PyTorch.

As the reference code builds it (``models/my_Lipschitz_Unet.py:21-148``,
``models/lipschitz_constraint_layer.py:24-159``, used by
``main_LRS_PnP_DIP_1-LiP.py:208-265``): a 4-down / 4-up stack of ``width``
channels without skips, every convolution spectrally normalised and every
batch norm normalised by the largest magnitude of its scale.  NCHW, with
``act`` LeakyReLU (slope 0.2) and ``up2`` nearest x2 upsampling:

    down d = 0..3:  y = act(SNBN(SNconv3x3_s2(y)));  y = act(SNBN(SNconv3x3(y)))
    up j = 0, 1:    y = act(SNBN(SNconv2x2(up2(y))))      (unpadded)
    up j = 2, 3:    y = act(SNBN(SNconv3x3(up2(y))))
    head:           y = act(SNBN(SNconv1x1(y)));  y = act(SNconv1x1(y))

At 36x36 the sizes run 36 -> 18 -> 9 -> 5 -> 3 and back (6 -> 5, 10 -> 9,
18, 36), each up stage ending at the size its down stage started from; the
reference takes only sizes at which that holds.  3x3 filters pad by one, by
reflection.

SNconv: W (out, in, k, k) is read as the matrix W2 (out, in k k); its
largest singular value sigma is estimated by ``power_iters`` steps of power
iteration from the layer's persistent vector u (out,),

    v = W2^T u / (|W2^T u| + 1e-12),   u = W2 v / (|W2 v| + 1e-12),

then sigma = |W2^T u|, and the layer convolves with W / max(1, sigma /
ln_lambda), sigma taken as a constant (no gradient flows through it).  u
keeps its last value for the next forward.  SNBN: training-mode batch
norm (batch statistics, biased variance, eps 1e-5) with scale and bias both
divided by max(1, max |scale|), that maximum a constant too.

One departure from the published code, which the configuration states:
the published layer takes sigma from an exact ``torch.svd`` at every
forward; this reference, like the configuration it serves (``sn_mode``
"power"), takes it by power iteration.

Parameters live in a flat dict keyed by the names the program's net gives
them (``SNConv2d_<n>.weight|bias|u``, ``SNBatchNorm2d_<n>.weight|bias``), so
that one dict of initial weights serves both; the ``u`` entries are state,
not parameters, and :func:`forward` replaces them with their advanced
values.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

WIDTH = 128
POWER_ITERS = 8
N_CONVS = 14
N_BNS = 13
UP_KERNELS = (2, 2, 3, 3)


def conv_shapes(channels: int, width: int = WIDTH) -> list:
    """``[(n, cin, cout, k, stride)]`` of the 14 convolutions, in order."""
    convs, cin = [], channels
    for d in range(4):
        convs += [(2 * d, cin, width, 3, 2), (2 * d + 1, width, width, 3, 1)]
        cin = width
    convs += [(8 + j, width, width, k, 1) for j, k in enumerate(UP_KERNELS)]
    return convs + [(12, width, width, 1, 1), (13, width, channels, 1, 1)]


def param_spec(channels: int, width: int = WIDTH) -> list:
    """``[(name, shape, kind)]`` of every entry, ``kind`` one of ``conv_w``
    (drawn U(+-sqrt(6 / fan_in)), Kaiming-uniform as the reference's
    ``conv()`` factory draws it), ``conv_b`` (zero), ``u`` (drawn N(0, 1)),
    ``bn_w`` (one), ``bn_b`` (zero)."""
    spec = []
    for n, cin, cout, k, _ in conv_shapes(channels, width):
        spec += [(f"SNConv2d_{n}.weight", (cout, cin, k, k), "conv_w"),
                 (f"SNConv2d_{n}.bias", (cout,), "conv_b"),
                 (f"SNConv2d_{n}.u", (cout,), "u")]
    for n in range(N_BNS):
        spec += [(f"SNBatchNorm2d_{n}.weight", (width,), "bn_w"),
                 (f"SNBatchNorm2d_{n}.bias", (width,), "bn_b")]
    return spec


def init_params(spec: list, generator: torch.Generator, device) -> dict:
    """One draw of every entry from ``generator``: all conv kernels from a
    single ``torch.rand`` call on ``device``, scaled per kernel, then all
    vectors u from a single ``torch.randn`` call."""
    n_w = sum(math.prod(shape) for _, shape, kind in spec if kind == "conv_w")
    n_u = sum(math.prod(shape) for _, shape, kind in spec if kind == "u")
    uw = torch.rand(n_w, generator=generator, device=device, dtype=torch.float32)
    uu = torch.randn(n_u, generator=generator, device=device, dtype=torch.float32)
    params, at_w, at_u = {}, 0, 0
    for name, shape, kind in spec:
        size = math.prod(shape)
        if kind == "conv_w":
            bound = math.sqrt(6.0 / (shape[1] * shape[2] * shape[3]))
            params[name] = (uw[at_w : at_w + size].reshape(shape) * 2.0 - 1.0) * bound
            at_w += size
        elif kind == "u":
            params[name] = uu[at_u : at_u + size].reshape(shape).clone()
            at_u += size
        elif kind == "bn_w":
            params[name] = torch.ones(shape, device=device)
        else:
            params[name] = torch.zeros(shape, device=device)
    return params


# -- the layers ----------------------------------------------------------------


def _reflect1(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Reflection padding by one along ``axis`` (``np.pad(mode='reflect')``:
    a length-1 axis repeats its entry)."""
    n = x.shape[axis]
    if n == 1:
        return torch.cat([x, x, x], dim=axis)
    return torch.cat([x.narrow(axis, 1, 1), x, x.narrow(axis, n - 2, 1)], dim=axis)


def sigma_power(w2: torch.Tensor, u: torch.Tensor, power_iters: int) -> tuple:
    """(sigma, advanced u) of the matrix ``w2`` by ``power_iters`` steps."""
    for _ in range(power_iters):
        v = w2.T @ u
        v = v / (torch.linalg.norm(v) + 1e-12)
        u = w2 @ v
        u = u / (torch.linalg.norm(u) + 1e-12)
    return torch.linalg.norm(w2.T @ u), u


def sn_conv(params: dict, n: int, x: torch.Tensor, stride: int, ln_lambda: float,
            power_iters: int) -> torch.Tensor:
    name = f"SNConv2d_{n}"
    w = params[name + ".weight"]
    with torch.no_grad():
        sigma, u = sigma_power(w.detach().reshape(w.shape[0], -1), params[name + ".u"], power_iters)
        params[name + ".u"] = u
        factor = torch.clamp(sigma / ln_lambda, min=1.0)
    if w.shape[-1] == 3:
        x = _reflect1(_reflect1(x, 2), 3)
    return F.conv2d(x, w / factor, params[name + ".bias"], stride=stride)


def sn_bn(params: dict, n: int, x: torch.Tensor) -> torch.Tensor:
    name = f"SNBatchNorm2d_{n}"
    w, b = params[name + ".weight"], params[name + ".bias"]
    top = torch.clamp(w.detach().abs().max(), min=1.0)
    return F.batch_norm(x, None, None, w / top, b / top, training=True, eps=1e-5)


def act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def forward(params: dict, x: torch.Tensor, ln_lambda: float = 1.0, power_iters: int = POWER_ITERS) -> torch.Tensor:
    """The net on an NCHW input; advances every ``SNConv2d_<n>.u`` of
    ``params`` in place of the dict's entry."""

    def block(n, y, stride=1):
        return act(sn_bn(params, n, sn_conv(params, n, y, stride, ln_lambda, power_iters)))

    y, sizes = x, []
    for d in range(4):
        sizes.append(tuple(y.shape[2:]))
        y = block(2 * d + 1, block(2 * d, y, stride=2))
    for j, target in enumerate(reversed(sizes)):
        y = block(8 + j, up2(y))
        if tuple(y.shape[2:]) != target:
            raise ValueError(f"an up stage gives {tuple(y.shape[2:])}, not {target}: the reference takes "
                             "sizes at which no resize runs, as 36x36")
    y = block(12, y)
    return act(sn_conv(params, 13, y, 1, ln_lambda, power_iters))


# -- the fit -------------------------------------------------------------------


class Fit(NamedTuple):
    out: torch.Tensor  # (B, H, W), the output of the last iteration run
    n_iters: int


def dip_fit(params0: dict, z: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, s,
            n_iters: Optional[int] = None, ln_lambda: float = 1.0,
            power_iters: int = POWER_ITERS) -> Fit:
    """A fresh 1-Lip fit (``get_DIP_out``, ``main_LRS_PnP_DIP_1-LiP.py:208-265``),
    the loop of :func:`reference.solver.dip_fit` with this net.

    ``z``, ``target``: (B, H, W); ``mask``: (H, W); ``s`` the reference's
    ``Setup``.  Each iteration runs the net on z (advancing every u), takes
    the loss mean((target m - out m)^2) and an Adam step over the weights
    and biases (lr ``dip_lr``, betas 0.9 / 0.999, eps 1e-8; the vectors u
    are not trained), then pushes that iteration's output (computed before
    the step) into a window of the last ``dip_window``; once the window is
    full its variance mean((w - mean(w))^2) is checked, and the fit stops
    when it has not gone below its lowest for ``dip_patience`` checks, or
    after ``dip_num_iter`` iterations.  ``n_iters`` runs exactly that many
    iterations instead."""
    params = {k: v.detach().clone() for k, v in params0.items()}
    trained = [k for k in params if not k.endswith(".u")]
    for k in trained:
        params[k].requires_grad_(True)
    opt = torch.optim.Adam([params[k] for k in trained], lr=s.dip_lr, betas=(0.9, 0.999), eps=1e-8)
    x, m = z[None], mask[None, None]
    tm = target[None] * m
    window, best, wait, out, n = [], math.inf, 0, None, 0
    limit = s.dip_num_iter if n_iters is None else n_iters
    while n < limit:
        pred = forward(params, x, ln_lambda, power_iters)
        loss = torch.mean((tm - pred * m) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        out = pred.detach()[0]
        n += 1
        if n_iters is not None:
            continue
        window.append(out.reshape(-1))
        if len(window) > s.dip_window:
            window.pop(0)
        if len(window) == s.dip_window:
            w = torch.stack(window)
            var = float(torch.mean((w - w.mean(dim=0)) ** 2))
            if var < best:
                best, wait = var, 0
            else:
                wait += 1
            if wait >= s.dip_patience:
                break
    return Fit(out, n)


def dip_prox(st, pr, s, dip_init: dict, dip_iters: Optional[int] = None, ln_lambda: float = 1.0,
             power_iters: int = POWER_ITERS) -> Fit:
    """The low-rank prox of ``dip_1lip`` (one problem of
    :func:`reference.solver.problem`): a fresh fit from ``dip_init`` with
    Z = X + lambda2/mu2 as input and the noisy cube as target; ``out`` is
    (P, B)."""
    h, w, b = pr.shape
    Z = st.X + st.lambda2 / s.mu2
    fit = dip_fit(dip_init, Z.reshape(h, w, b).permute(2, 0, 1), pr.Y.reshape(h, w, b).permute(2, 0, 1),
                  pr.mask[:, 0].reshape(h, w), s, n_iters=dip_iters, ln_lambda=ln_lambda,
                  power_iters=power_iters)
    return Fit(fit.out.permute(1, 2, 0).reshape(h * w, b), fit.n_iters)


# -- operations ----------------------------------------------------------------


def _down(n: int) -> int:
    """Output length of a 3x3 conv with reflection padding 1 at stride 2."""
    return (n + 2 - 3) // 2 + 1


def conv_layers(height: int, width: int, channels: int, width_ch: int = WIDTH) -> list:
    """Every convolution of one forward pass as ``(n, cin, cout, k, h_out,
    w_out, input_needs_grad)``, from the shapes alone."""
    shapes = {n: (cin, cout, k) for n, cin, cout, k, _ in conv_shapes(channels, width_ch)}
    layers, sizes, h, w = [], [], height, width
    for d in range(4):
        sizes.append((h, w))
        h, w = _down(h), _down(w)
        layers.append((2 * d, *shapes[2 * d], h, w, d > 0))
        layers.append((2 * d + 1, *shapes[2 * d + 1], h, w, True))
    for j, (ht, wt) in enumerate(reversed(sizes)):
        n = 8 + j
        k = shapes[n][2]
        grow = 2 * ((k - 1) // 2) - k + 1  # an unpadded 2x2 filter takes one off
        layers.append((n, *shapes[n], 2 * h + grow, 2 * w + grow, True))
        h, w = ht, wt
    layers.append((12, *shapes[12], h, w, True))
    layers.append((13, *shapes[13], h, w, True))
    return layers


def fit_flops_per_iteration(height: int, width: int, channels: int, width_ch: int = WIDTH,
                            power_iters: int = POWER_ITERS) -> int:
    """Floating-point operations of one 1-Lip DIP iteration: the forward
    convolutions, their weight gradients and the input gradients of every
    convolution whose input needs one (not the first, which reads the net's
    input), and the spectral norms' matrix-vector products, each
    2 x out x (in k k).  A multiply-add counts as two.  Batch norm, the
    activations, the norms' reductions and divides, the loss and Adam
    (elementwise) are not counted."""
    total = 0
    for _, cin, cout, k, ho, wo, input_grad in conv_layers(height, width, channels, width_ch):
        total += 2 * cin * cout * k * k * ho * wo * (3 if input_grad else 2)
        total += (2 * power_iters + 1) * 2 * cout * cin * k * k
    return total
