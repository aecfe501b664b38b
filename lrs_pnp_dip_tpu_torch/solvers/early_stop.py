"""Windowed-variance DIP early stopping (counterpart of
``lrs_pnp_dip_tpu/solvers/early_stop.py``, ``exact`` mode).

Reference semantics (``main_LRS_PnP_DIP_pro.py:74-107,250-272``): keep the
last ``size`` (=30) network outputs; once the window is full, the score is
``mean((window - window.mean(0))^2)``.  Track the best score; when it has
not improved for ``patience`` (=60) consecutive checks, stop.

The ring buffer lives on the tensors' device; the scalar bookkeeping lives
on the host, since the fit loop reads the stop flag every iteration
anyway.  The score is computed only once the window is full, the only time
it is used.  ``es_mode='incremental'`` is not ported yet (ROADMAP Queue A,
item 10).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class EarlyStopState:
    window: torch.Tensor  # (size, D) ring buffer of flattened outputs
    count: int = 0  # total pushes so far
    best_score: float = math.inf  # best (lowest) windowed variance seen
    best_iter: int = 0  # iteration of the best variance
    wait: int = 0  # consecutive non-improving checks
    stop: bool = False


def init_early_stop(size: int, dim: int, device="cpu") -> EarlyStopState:
    return EarlyStopState(
        window=torch.zeros((size, dim), dtype=torch.float32, device=device)
    )


def update_early_stop(
    es: EarlyStopState, out_flat: torch.Tensor, cur_iter: int, patience: int
) -> EarlyStopState:
    """Push one output and advance the state machine.  The ring buffer is
    written in place; returns ``es``."""
    size = es.window.shape[0]
    es.window[es.count % size] = out_flat
    es.count += 1
    if es.count >= size:
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
