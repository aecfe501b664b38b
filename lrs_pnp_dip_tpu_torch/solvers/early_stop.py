"""Windowed-variance DIP early stopping as a state machine of device tensors
(counterpart of ``lrs_pnp_dip_tpu/solvers/early_stop.py``).

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
  buffer, the origin becoming the window's mean.

Every field, the scalars too (``count``, ``best_score``, ``best_iter``,
``wait``, ``stop``), is a tensor on the window's device, and
:func:`update_early_stop` writes them in place with ``torch.where``, as the
JAX code does: it reads nothing back to the host, so a DIP iteration with
its early stop can be captured in a CUDA graph and replayed.  The resync
runs under ``torch.where`` too, both branches at every check, as the JAX
code's ``lax.cond`` does under ``vmap``: ``count`` is a function of the
iteration, so a second captured graph for the resync iterations would also
work, but it would need a copy of the count logic on the host, and the
resync costs one more pass over the window, the traffic the exact mode
spends at every check.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch


@dataclasses.dataclass
class EarlyStopState:
    window: torch.Tensor  # (size, D) ring buffer of flattened outputs
    count: torch.Tensor  # int64: total pushes so far
    best_score: torch.Tensor  # f32: best (lowest) windowed variance seen
    best_iter: torch.Tensor  # int64: iteration of the best variance
    wait: torch.Tensor  # int64: consecutive non-improving checks
    stop: torch.Tensor  # bool
    # incremental mode only (None otherwise): (D,) running sums of
    # (w - origin) and (w - origin)^2, and the origin they are taken about
    sum: Optional[torch.Tensor] = None
    sumsq: Optional[torch.Tensor] = None
    origin: Optional[torch.Tensor] = None


def init_early_stop(
    size: int, dim: int, incremental: bool = False, device="cpu"
) -> EarlyStopState:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    es = EarlyStopState(
        window=zeros(size, dim),
        count=zeros(dtype=torch.int64),
        best_score=torch.full((), math.inf, dtype=torch.float32, device=device),
        best_iter=zeros(dtype=torch.int64),
        wait=zeros(dtype=torch.int64),
        stop=zeros(dtype=torch.bool),
    )
    if incremental:
        es.sum, es.sumsq, es.origin = zeros(dim), zeros(dim), zeros(dim)
    return es


def reset_early_stop(es: EarlyStopState) -> None:
    """Return ``es`` to its initial state in place (its tensors keep their
    storage, which a captured graph holds)."""
    for t in (es.window, es.count, es.best_iter, es.wait, es.stop, es.sum, es.sumsq, es.origin):
        if t is not None:
            t.zero_()
    es.best_score.fill_(math.inf)


def update_early_stop(
    es: EarlyStopState,
    out_flat: torch.Tensor,
    cur_iter: Union[int, torch.Tensor],
    patience: int,
    enabled: Optional[torch.Tensor] = None,
) -> EarlyStopState:
    """Push one output and advance the state machine, every field written
    in place; returns ``es``.  ``enabled`` (a bool tensor) masks the whole
    update: where it is false the state stays exactly as it was."""
    size = es.window.shape[0]
    idx = torch.remainder(es.count, size).reshape(1)
    evicted = es.window.index_select(0, idx)[0]
    # a disabled push writes the evicted row back: the window stays as it was
    row = out_flat if enabled is None else torch.where(enabled, out_flat, evicted)
    es.window.index_copy_(0, idx, row[None])
    window = es.window
    count = es.count + 1
    if es.sum is not None:
        # S1's increment does not depend on the origin; S2's must use the
        # origin the running sums were accumulated under
        c = es.origin
        s1 = es.sum + (out_flat - evicted)
        s2 = es.sumsq + ((out_flat - c) ** 2 - (evicted - c) ** 2)
        # exact resync against f32 drift, the origin moved to the window mean
        resync = torch.remainder(count, size) == 0
        c_new = torch.mean(window, dim=0)
        d = window - c_new[None, :]
        s1 = torch.where(resync, torch.sum(d, dim=0), s1)
        s2 = torch.where(resync, torch.sum(d * d, dim=0), s2)
        c = torch.where(resync, c_new, c)
        ave = s1 / size
        var = torch.mean(torch.clamp(s2 / size - ave * ave, min=0.0))
    else:
        ave = torch.mean(window, dim=0)
        var = torch.mean((window - ave[None, :]) ** 2)
    filled = count >= size
    better = filled & (var < es.best_score)
    best_score = torch.where(better, var, es.best_score)
    best_iter = torch.where(better, cur_iter, es.best_iter)
    wait = torch.where(filled, torch.where(better, 0, es.wait + 1), es.wait)
    stop = es.stop | (filled & (wait >= patience))
    new = [(es.count, count), (es.best_score, best_score),
           (es.best_iter, best_iter), (es.wait, wait), (es.stop, stop)]
    if es.sum is not None:
        new += [(es.sum, s1), (es.sumsq, s2), (es.origin, c)]
    for old, value in new:
        old.copy_(value if enabled is None else torch.where(enabled, value, old))
    return es
