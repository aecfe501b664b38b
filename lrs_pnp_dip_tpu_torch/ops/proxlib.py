"""Proximal-operator and measurement-operator library (counterpart of
``lrs_pnp_dip_tpu/ops/proxlib.py``; reference ``admm_utils.py:13-142``):

  * measurement operators: random-pixel inpainting and strided-grid
    super-resolution, each as an (A, At, diag) triple;
  * proxes: l1 (soft threshold), isotropic TV (Chambolle's dual
    projection), the NLM and BM3D plug-in denoisers, l-inf via Moreau;
  * projections: l-inf ball, simplex (sorted cumulative threshold), l1 ball.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..utils.device import resolve_device
from .bm3d import Bm3dConfig
from .bm3d import bm3d_prox as _bm3d_prox
from .nlm import nlm2d
from .shrinkage import soft_threshold


class MeasurementOp(NamedTuple):
    """Linear measurement operator with adjoint and diagonal."""

    A: Callable[[torch.Tensor], torch.Tensor]
    At: Callable[[torch.Tensor], torch.Tensor]
    diag: torch.Tensor  # diag(A^T A) as an image-shaped mask


def inpainting_operator(
    generator: torch.Generator, shape: Tuple[int, ...], keep_ratio: float
) -> MeasurementOp:
    """Random-pixel subsampling (reference ``A_inpainting``), the mask drawn
    from ``generator`` on its device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    mask = (u < keep_ratio).to(torch.float32)
    return MeasurementOp(A=lambda x: mask * x, At=lambda y: mask * y, diag=mask)


def superresolution_operator(shape: Tuple[int, int], factor: int, device="cuda") -> MeasurementOp:
    """Strided-grid subsampling (reference ``A_superresolution``): every
    ``factor``-th pixel on both axes is kept.  The mask lives on ``device``:
    the card by default, which raises when there is none."""
    device = resolve_device(device)
    h, w = shape
    rows = (torch.arange(h, device=device) % factor == 0)[:, None]
    cols = (torch.arange(w, device=device) % factor == 0)[None, :]
    mask = (rows & cols).to(torch.float32)
    return MeasurementOp(A=lambda x: mask * x, At=lambda y: mask * y, diag=mask)


def l1_prox(x: torch.Tensor, tau) -> torch.Tensor:
    return soft_threshold(x, tau)


def tv_prox(x: torch.Tensor, lam, n_iter: int = 50) -> torch.Tensor:
    """Isotropic total-variation prox of a 2-D image (Chambolle 2004 dual
    projection, in place of the reference's ``prox_tv`` dependency)."""
    tau = 0.25

    def grad(u):
        gx = torch.diff(u, dim=0, append=u[-1:, :])
        gy = torch.diff(u, dim=1, append=u[:, -1:])
        return gx, gy

    def div(px, py):
        dx = torch.cat([px[:1], px[1:-1] - px[:-2], -px[-2:-1]], dim=0)
        dy = torch.cat([py[:, :1], py[:, 1:-1] - py[:, :-2], -py[:, -2:-1]], dim=1)
        return dx + dy

    px, py = torch.zeros_like(x), torch.zeros_like(x)
    for _ in range(n_iter):
        gx, gy = grad(div(px, py) - x / lam)
        denom = 1.0 + tau * torch.sqrt(gx * gx + gy * gy)
        px, py = (px + tau * gx) / denom, (py + tau * gy) / denom
    return x - lam * div(px, py)


def nlm_prox(x: torch.Tensor, h, patch_size: int = 3, patch_distance: int = 3) -> torch.Tensor:
    """Plug-and-play NLM denoiser as a prox (reference ``nlm_prox``)."""
    return nlm2d(x, h, patch_size, patch_distance)


def bm3d_prox(x: torch.Tensor, sigma, cfg: Optional[Bm3dConfig] = None) -> torch.Tensor:
    """Plug-and-play BM3D denoiser as a prox (reference ``bm3d_prox``,
    ``admm_utils.py:60-75``; here :mod:`.bm3d`)."""
    return _bm3d_prox(x, sigma, cfg if cfg is not None else Bm3dConfig())


def linf_project(x: torch.Tensor, radius) -> torch.Tensor:
    """Projection onto the l-inf ball (reference ``linf_proj``)."""
    return torch.clamp(x, -radius, radius)


def simplex_project(x: torch.Tensor, radius=1.0) -> torch.Tensor:
    """Euclidean projection onto the simplex of size ``radius`` (sorted
    cumulative-threshold algorithm)."""
    v = x.reshape(-1)
    n = v.shape[0]
    u = torch.sort(v, descending=True).values
    css = torch.cumsum(u, dim=0) - radius
    idx = torch.arange(1, n + 1, dtype=v.dtype, device=v.device)
    cond = u - css / idx > 0
    rho = torch.max(torch.where(cond, torch.arange(n, device=v.device), -1))
    theta = css[rho] / (rho + 1.0)
    return torch.clamp(v - theta, min=0.0).reshape(x.shape)


def l1_project(x: torch.Tensor, radius=1.0) -> torch.Tensor:
    """Projection onto the l1 ball via the simplex projection of |x|."""
    inside = torch.sum(torch.abs(x)) <= radius
    proj = torch.sign(x) * simplex_project(torch.abs(x), radius)
    return torch.where(inside, x, proj)


def linf_prox(x: torch.Tensor, tau) -> torch.Tensor:
    """Prox of tau * ||.||_inf via Moreau: x - tau * proj_l1ball(x / tau)."""
    return x - tau * l1_project(x / tau, 1.0)
