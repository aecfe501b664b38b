"""Singular-value thresholding, the nuclear-norm prox of the `lrs_pnp`
variant (counterpart of ``lrs_pnp_dip_tpu/ops/svt.py``).

Reference semantics (``main_LRS_PnP.py:118-124``): full SVD of the (P, B)
iterate, soft-threshold the singular values, recompose.  For P >> B the same
operator comes from the B x B Gram matrix:

    G = X^T X = V S^2 V^T                      (eigh, B x B)
    SVT_tau(X) = X V diag(shrink(s) / s) V^T   with s = sqrt(eig)

two matrix products and one small ``torch.linalg.eigh``.  Every function
here takes a leading batch axis, ``(..., P, B)``: the lockstep engines
threshold all their lanes in one batched ``eigh``.

The eigenvalues of an f32 Gram carry an absolute error of about
1e-7 * lambda_max, so a singular value close to ``tau`` shrinks to slightly
different values here and in the JAX package; the tests state the tolerance.
"""

from __future__ import annotations

import torch

from ..utils.profiling import annotate
from .shrinkage import soft_threshold


def svt(X: torch.Tensor, tau) -> torch.Tensor:
    """Direct SVD route (oracle / small problems)."""
    U, s, Vh = torch.linalg.svd(X, full_matrices=False)
    return (U * soft_threshold(s, tau)[..., None, :]) @ Vh


def _shrink_ratio(w: torch.Tensor, tau, eps: float = 1e-12) -> torch.Tensor:
    """The shrink ratio of each eigenvalue ``w`` of a Gram matrix (0 where
    the singular value is at most ``eps``)."""
    s = torch.sqrt(torch.clamp(w, min=0.0))
    return torch.where(
        s > eps, soft_threshold(s, tau) / torch.clamp(s, min=eps), torch.zeros_like(s)
    )


def _gram_spectral_filter(G: torch.Tensor, tau):
    """Eigendecompose G = X^T X; returns the eigenvectors and their shrink ratios."""
    w, V = torch.linalg.eigh(G)
    return V, _shrink_ratio(w, tau)


def gram(X: torch.Tensor) -> torch.Tensor:
    """X^T X over the trailing two axes."""
    return X.transpose(-1, -2) @ X


def svt_from_eigh(X: torch.Tensor, w: torch.Tensor, V: torch.Tensor, tau) -> torch.Tensor:
    """:func:`svt_gram` from ``torch.linalg.eigh(gram(X))``.  ``eigh``
    checks cuSOLVER's status on the host, which a CUDA graph cannot
    capture, so the device-resident solve runs it between two graphs and
    this half in the second."""
    return ((X @ V) * _shrink_ratio(w, tau)[..., None, :]) @ V.transpose(-1, -2)


def svt_gram(X: torch.Tensor, tau) -> torch.Tensor:
    """Gram + eigh route: exact SVT for any X with a small trailing axis."""
    G = gram(X)
    with annotate("svt.eigh"):
        w, V = torch.linalg.eigh(G)
    return svt_from_eigh(X, w, V, tau)


def singular_values_gram(X: torch.Tensor) -> torch.Tensor:
    """Singular values (descending) via the Gram route (reference
    ``print_singular_value``, ``main_LRS_PnP_DIP_pro.py:174-182``)."""
    w = torch.linalg.eigvalsh(X.transpose(-1, -2) @ X)
    return torch.sqrt(torch.clamp(w, min=0.0)).flip(-1)


def singular_energy_ratio(X: torch.Tensor, p: int) -> torch.Tensor:
    """Fraction of singular-value mass in the top p-1 values: the reference
    ``Accu_Energy_ratio`` (``:110-115``) sums the top ``p-1``, not ``p``."""
    s = singular_values_gram(X)
    return torch.sum(s[..., : p - 1], dim=-1) / torch.sum(s, dim=-1)
