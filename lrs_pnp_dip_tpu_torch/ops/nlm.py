"""The closed-form 1-D non-local-means denoiser of the PnP-ISTA loop
(counterpart of ``lrs_pnp_dip_tpu/ops/nlm.py:nlm_column_batch_fast``).

The MATLAB-twin NLM (``nlm_classic``, ``nlm2d``, ``nlm_column``) is not
ported yet (ROADMAP Queue A, item 13)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nlm_column_batch_fast(G: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """skimage fast-mode NLM (patch 3, distance 3) on a batch of (K, 1)
    images, collapsed exactly to a 1-D filter along K.

    Reflect pad 5; for delta in {1, 2, 3} the weight at row r is
    ``7 * exp(-3 * sum_{u=-1..1} (p[r+u] - p[r+delta+u])^2 / (9 h^2))``,
    applied forward and backward; the self weight is 8; the output is
    num / den.

    G: (nB, K); h: (nB,) per-block bandwidth.  Returns (nB, K).
    """
    nb, K = G.shape
    pad = 5
    P = F.pad(G.to(torch.float32)[:, None, :], (pad, pad), mode="reflect")[:, 0]
    h2s2 = torch.clamp((h.to(torch.float32) ** 2) * 9.0, min=1e-30)[:, None]

    num = 8.0 * P
    den = torch.full_like(P, 8.0)
    L = P.shape[1]
    for delta in (1, 2, 3):
        # sq[:, r] = (P[r] - P[r+delta])^2, r in [0, L-delta)
        sq = (P[:, : L - delta] - P[:, delta:]) ** 2
        # dist[:, j] = 3 * (sq[j] + sq[j+1] + sq[j+2]): the window about row j+1
        dist = 3.0 * (sq[:, :-2] + sq[:, 1:-1] + sq[:, 2:])
        w = 7.0 * torch.exp(-dist / h2s2)  # w[:, j] is the weight at row j+1
        # forward: out[r] += w_delta(r) * P[r+delta]
        num[:, 1 : L - delta - 1] += w * P[:, 1 + delta : L - 1]
        den[:, 1 : L - delta - 1] += w
        # backward: out[r+delta] += w_delta(r) * P[r]
        num[:, 1 + delta : L - 1] += w * P[:, 1 : L - delta - 1]
        den[:, 1 + delta : L - 1] += w
    return (num / den)[:, pad : pad + K]
