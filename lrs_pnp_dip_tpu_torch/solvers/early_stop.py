"""Windowed-variance DIP early stopping (counterpart of
``lrs_pnp_dip_tpu/solvers/early_stop.py``).

Reference semantics (``main_LRS_PnP_DIP_pro.py:74-107,250-272``): keep the
last ``size`` (=30) network outputs; once the window is full, the score is
``mean((window - window.mean(0))^2)``.  Track the best score; when it has
not improved for ``patience`` (=60) consecutive checks, stop.

Two evaluators of the score:

* ``exact`` (default): the reduction over the whole (size, D) window at
  every check, in the reference's order of operations.
* ``incremental``: per-pixel sums ``S1_j = sum_i (w_ij - c_j)`` and
  ``S2_j = sum_i (w_ij - c_j)^2`` about a per-pixel shifted origin ``c_j``,
  updated in O(D) per push (add the new row, take the evicted one away), and
  ``var = mean_j max(S2_j / n - (S1_j / n)^2, 0)``: the same quantity by the
  Koenig-Huygens identity.  The origin keeps both sums at the scale of the
  variance (about zero they cancel catastrophically in f32 once
  ``var << mean^2``, which is where the stop is decided).  Every ``size``
  pushes the sums and the origin are recomputed exactly from the ring
  buffer, the origin becoming the window's mean.  That resync is a plain
  Python ``if`` here: it runs once per window period in a single fit and in
  the lockstep engines alike, so the JAX package's caveat (under ``vmap``
  both branches of its ``lax.cond`` run at every check) does not exist in
  the port.

The ring buffer and the sums live on the tensors' device; the scalar
bookkeeping lives on the host, since the fit loop reads the stop flag every
iteration anyway.  The score is computed only once the window is full, the
only time it is used.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass
class EarlyStopState:
    window: torch.Tensor  # (size, D) ring buffer of flattened outputs
    count: int = 0  # total pushes so far
    best_score: float = math.inf  # best (lowest) windowed variance seen
    best_iter: int = 0  # iteration of the best variance
    wait: int = 0  # consecutive non-improving checks
    stop: bool = False
    # incremental mode only (None otherwise): (D,) running sums of
    # (w - origin) and (w - origin)^2, and the origin they are taken about
    sum: Optional[torch.Tensor] = None
    sumsq: Optional[torch.Tensor] = None
    origin: Optional[torch.Tensor] = None


def init_early_stop(
    size: int, dim: int, incremental: bool = False, device="cpu"
) -> EarlyStopState:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    es = EarlyStopState(window=zeros(size, dim))
    if incremental:
        es.sum, es.sumsq, es.origin = zeros(dim), zeros(dim), zeros(dim)
    return es


def update_early_stop(
    es: EarlyStopState, out_flat: torch.Tensor, cur_iter: int, patience: int
) -> EarlyStopState:
    """Push one output and advance the state machine.  The ring buffer and
    the running sums are written in place; returns ``es``."""
    size = es.window.shape[0]
    idx = es.count % size
    incremental = es.sum is not None
    if incremental:
        # S1's increment does not depend on the origin; S2's must use the
        # origin the running sums were accumulated under
        evicted, c = es.window[idx], es.origin
        es.sum += out_flat - evicted
        es.sumsq += (out_flat - c) ** 2 - (evicted - c) ** 2
    es.window[idx] = out_flat
    es.count += 1
    if incremental and es.count % size == 0:
        # exact resync against f32 drift; the origin moves to the window mean
        es.origin = torch.mean(es.window, dim=0)
        d = es.window - es.origin[None, :]
        es.sum, es.sumsq = torch.sum(d, dim=0), torch.sum(d * d, dim=0)
    if es.count >= size:
        if incremental:
            ave = es.sum / size
            var = float(torch.mean(torch.clamp(es.sumsq / size - ave * ave, min=0.0)))
        else:
            ave = torch.mean(es.window, dim=0)
            var = float(torch.mean((es.window - ave[None, :]) ** 2))
        if var < es.best_score:
            es.best_score = var
            es.best_iter = int(cur_iter)
            es.wait = 0
        else:
            es.wait += 1
        es.stop = es.stop or es.wait >= patience
    return es
