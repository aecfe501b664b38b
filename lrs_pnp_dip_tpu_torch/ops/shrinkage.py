"""Soft-thresholding, the l1 prox (counterpart of
``lrs_pnp_dip_tpu/ops/shrinkage.py``; reference ``Shrinkage_Operator`` /
``soft_thresh``, ``main_LRS_PnP_DIP_pro.py:162-166,185-186``)."""

from __future__ import annotations

import torch


def soft_threshold(x: torch.Tensor, tau) -> torch.Tensor:
    """sign(x) * max(|x| - tau, 0)."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - tau, min=0.0)
