"""Closed-form data-fidelity update and dual updates (counterpart of
``lrs_pnp_dip_tpu/ops/fidelity.py``).

Reference (``main_LRS_PnP_DIP_pro.py:425-456``):

    X = (gamma M^T Y + mu1 IMout + mu2 U - lambda1_sum - lambda2)
        / (gamma M^T M + mu1 Weight + mu2)

with IMout and lambda1_sum the summed (not averaged) block scatters and
Weight the per-entry block coverage.  The duals then update with the raw
summed IMout (a reference quirk kept on purpose):

    lambda1 += mu1 (X - IMout);   lambda2 += mu2 (X - U)
"""

from __future__ import annotations

from typing import Tuple

import torch

from .blocks import BlockGrid, extract_blocks, scatter_blocks


def data_fidelity_update(
    Y: torch.Tensor,  # (P, B) observed matricized image (M^T Y)
    mask: torch.Tensor,  # (P, B) observation mask (M^T M diagonal)
    phi_blocks: torch.Tensor,  # (nB, bb*bb) sparse-prox reconstructed blocks
    U: torch.Tensor,  # (P, B) low-rank / DIP prox output
    lambda1: torch.Tensor,
    lambda2: torch.Tensor,
    grid: BlockGrid,
    gamma: float,
    mu1: float,
    mu2: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (X, IMout).  IMout is needed for the lambda1 dual update."""
    im_out = scatter_blocks(phi_blocks, grid)
    weight = grid.weight(Y.device)
    lambda1_sum = scatter_blocks(extract_blocks(lambda1, grid), grid)
    X = (gamma * Y + mu1 * im_out + mu2 * U - lambda1_sum - lambda2) / (
        gamma * mask + mu1 * weight + mu2
    )
    return X, im_out


def dual_updates(
    lambda1: torch.Tensor,
    lambda2: torch.Tensor,
    X: torch.Tensor,
    im_out: torch.Tensor,
    U: torch.Tensor,
    mu1: float,
    mu2: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return lambda1 + mu1 * (X - im_out), lambda2 + mu2 * (X - U)
