"""Lipschitz-constrained layers: spectral normalisation (counterpart of
``lrs_pnp_dip_tpu/models/lipschitz.py``).

Reference semantics (``models/lipschitz_constraint_layer.py:24-159``):

  * spectrally normalised conv: each forward takes the largest singular
    value sigma of the weight reshaped to (out, -1), detached from the
    graph, and convolves with ``w / max(1, sigma / ln_lambda)``, which
    softly holds the layer's Lipschitz constant at ``ln_lambda``;
  * batch norm with spectral normalisation: scale AND bias are divided by
    ``max(sigma_target, max|scale|)``, that maximum detached.

sigma comes from an exact SVD (``sn_mode='exact'``) or from power iteration
with a persistent vector ``u`` (``'power'``, the default).  ``u`` is model
state, not a parameter: a buffer that ``reset_parameters`` draws from a
normal and that every forward advances in place under ``no_grad``; it is
part of the state dict, so a transplanted init carries it.

sigma depends on a conv's weight and ``u`` alone, not on its input, so a net
takes the power iteration of all its convs in one call at the start of its
forward (:func:`spectral_norms`, through :func:`conv_factors`) and hands each
conv its factor.  On the CPU that call runs :func:`_sigma_max_power` conv by
conv, the plain version; on the card it is one launch of a hand-written
kernel (:mod:`..ops.spectral_norm_cuda`) for the whole group.

The modules run NCHW inside, like :mod:`.common`.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.spectral_norm_cuda import SN_KERNEL
from .common import pad_input


def _sigma_max_exact(w2d: torch.Tensor) -> torch.Tensor:
    return torch.linalg.matrix_norm(w2d, ord=2)


def _sigma_max_power(w2d: torch.Tensor, u: torch.Tensor, n_iter: int):
    """Power iteration on W W^T; returns (sigma, new_u)."""
    for _ in range(n_iter):
        v = w2d.T @ u
        v = v / (torch.linalg.norm(v) + 1e-12)
        u = w2d @ v
        u = u / (torch.linalg.norm(u) + 1e-12)
    sigma = torch.linalg.norm(w2d.T @ u)
    return sigma, u


def spectral_norms(
    weights: Sequence[torch.Tensor],
    us: Sequence[torch.Tensor],
    ln_lambdas: Sequence[float],
    n_iters: Sequence[int],
) -> torch.Tensor:
    """sigma of each weight (viewed as (out, -1), in f32) by ``n_iters``
    power steps from its ``u``, which advances in place, and the factor
    ``max(1, sigma / ln_lambda)``: a (2, G) f32 tensor, sigmas then factors.
    On the CPU each weight runs :func:`_sigma_max_power` in turn; on any
    other device the group is one launch of the kernel, or the call raises."""
    with torch.no_grad():
        w2ds = [w.reshape(w.shape[0], -1).to(torch.float32) for w in weights]
        if w2ds[0].device.type != "cpu":
            return SN_KERNEL.launch(w2ds, us, ln_lambdas, n_iters)
        sigmas, factors = [], []
        for w2d, u, ln_lambda, n_iter in zip(w2ds, us, ln_lambdas, n_iters):
            sigma, new_u = _sigma_max_power(w2d, u, n_iter)
            u.copy_(new_u)
            sigmas.append(sigma)
            factors.append(torch.clamp(sigma / ln_lambda, min=1.0))
        return torch.stack([torch.stack(sigmas), torch.stack(factors)])


def conv_factors(convs: Sequence["SNConv2d"], weights: Sequence[torch.Tensor]) -> List[Optional[torch.Tensor]]:
    """Each conv's factor for its weight in ``weights`` (None where the
    constraint is off): the power-iteration convs' in one call of
    :func:`spectral_norms`, the exact ones' by their own SVD."""
    power = [i for i, conv in enumerate(convs) if hasattr(conv, "u")]
    factors = [None if i in power else conv.factor(weights[i]) for i, conv in enumerate(convs)]
    if power:
        table = spectral_norms(
            [weights[i] for i in power], [convs[i].u for i in power],
            [convs[i].ln_lambda for i in power], [convs[i].power_iters for i in power],
        )
        for k, i in enumerate(power):
            factors[i] = table[1, k]
    return factors


def _kaiming_uniform_(weight: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """U(+-sqrt(6 / fan_in)): variance 2 / fan_in, as the JAX package's
    ``kaiming_uniform_init``."""
    fan_in = weight[0].numel()
    bound = math.sqrt(6.0 / fan_in)
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


class SNConv2d(nn.Module):
    """Conv2d whose weight is divided by ``max(1, sigma / ln_lambda)``.

    ``ln_lambda <= 0`` turns the constraint off (reference ``conv``
    factory, ``lipschitz_constraint_layer.py:65-78``)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int = 3,
        stride: int = 1,
        ln_lambda: float = 1.0,
        bias: bool = True,
        pad: str = "zero",
        sn_mode: str = "power",  # 'power' | 'exact'
        power_iters: int = 8,
    ):
        super().__init__()
        if sn_mode not in ("power", "exact"):
            raise ValueError(f"sn_mode must be 'power' or 'exact', got {sn_mode!r}")
        self.kernel_size = kernel_size
        self.stride = stride
        self.ln_lambda = ln_lambda
        self.pad = pad
        self.sn_mode = sn_mode
        self.power_iters = power_iters
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if bias else None
        if ln_lambda > 0 and sn_mode == "power":
            self.register_buffer("u", torch.empty(features))
        self.reset_parameters()

    @property
    def power_products(self) -> int:
        """Matrix-vector products a forward runs to estimate sigma: two a
        power step and one for sigma itself; 0 without power iteration."""
        return 2 * self.power_iters + 1 if hasattr(self, "u") else 0

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _kaiming_uniform_(self.weight, generator)
        with torch.no_grad():
            if self.bias is not None:
                self.bias.zero_()
            if hasattr(self, "u"):
                self.u.normal_(generator=generator)

    def factor(self, weight: torch.Tensor) -> Optional[torch.Tensor]:
        """``max(1, sigma / ln_lambda)`` of ``weight``, sigma in f32 whatever
        type the weight was cast to; advances ``u`` in power mode.  None
        without the constraint."""
        if self.ln_lambda <= 0:
            return None
        if self.sn_mode == "power":
            return spectral_norms([weight], [self.u], [self.ln_lambda], [self.power_iters])[1, 0]
        with torch.no_grad():
            sigma = _sigma_max_exact(weight.reshape(weight.shape[0], -1).to(torch.float32))
            return torch.clamp(sigma / self.ln_lambda, min=1.0)

    def forward(
        self, x: torch.Tensor, weight: Optional[torch.Tensor] = None, factor: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Alone, the conv takes its own factor.  A net that took the factors
        of all its convs at once (:func:`conv_factors`) passes the weight it
        read and that weight's factor."""
        if weight is None:
            weight = self.weight
            factor = self.factor(weight)
        if factor is not None:
            weight = weight / factor.to(weight.dtype)
        x = pad_input(x, (self.kernel_size - 1) // 2, self.pad)
        return F.conv2d(x, weight, self.bias, stride=self.stride)


class SNBatchNorm2d(nn.Module):
    """Training-mode batch norm (biased variance, no running statistics)
    whose scale and bias are divided by ``max(sigma, max|scale|)``."""

    def __init__(self, channels: int, sigma: float = 1.0, eps: float = 1e-5):
        super().__init__()
        self.sigma = sigma
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cur = torch.clamp(self.weight.detach().abs().max(), min=self.sigma)
        return F.batch_norm(
            x, None, None, self.weight / cur, self.bias / cur, training=True, eps=self.eps
        )


class ConvOperatorNorm(nn.Module):
    """Conv with function-space spectral normalisation: sigma_max of the
    conv operator on an ``input_size`` feature map, estimated by power
    iteration that alternates the conv and its transpose on a persistent
    feature map ``u``; the weight is then rescaled to ``target_norm``
    (reference ``models/conv_sn_chen.py:16-167``)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        input_size: Tuple[int, int],
        kernel_size: int = 3,
        stride: int = 1,
        target_norm: float = 1.0,
        bias: bool = True,
        pad: str = "zero",
        power_iters: int = 1,
    ):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.target_norm = target_norm
        self.pad = pad
        self.power_iters = power_iters
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if bias else None
        self.register_buffer("u", torch.empty(1, features, *input_size))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _kaiming_uniform_(self.weight, generator)
        with torch.no_grad():
            if self.bias is not None:
                self.bias.zero_()
            self.u.fill_(1.0 / math.sqrt(self.u.numel()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad_amt = (self.kernel_size - 1) // 2
        with torch.no_grad():
            w = self.weight.to(torch.float32)
            w_adj = w.transpose(0, 1).flip(2, 3)
            u = self.u
            for _ in range(self.power_iters):
                v = F.conv2d(u, w_adj, padding=pad_amt)
                v = v / (torch.linalg.norm(v) + 1e-12)
                u = F.conv2d(v, w, padding=pad_amt)
                u = u / (torch.linalg.norm(u) + 1e-12)
            sigma = torch.clamp(torch.sum(u * F.conv2d(v, w, padding=pad_amt)), min=1e-12)
            self.u.copy_(u)
        weight = self.weight / sigma.to(self.weight.dtype) * self.target_norm
        x = pad_input(x, pad_amt, self.pad)
        return F.conv2d(x, weight, self.bias, stride=self.stride)
