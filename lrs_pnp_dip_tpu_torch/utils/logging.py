"""Structured metric logging (jsonl) + stage timing (a copy of
``lrs_pnp_dip_tpu/utils/logging.py``, which has no JAX in it).

The reference's observability is stdout prints and MATLAB-style tic/toc
globals (``main_LRS_PnP_DIP_pro.py:41-52``).  Here: a jsonl metric writer
and a context-manager stage timer whose totals feed the same logger.  Both
read the host's wall clock: time a stage that ends in device work only after
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional


class MetricLogger:
    """Append-only jsonl metric log with wall-clock stamps."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._f = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, **record):
        record.setdefault("t", round(time.time() - self._t0, 3))
        line = json.dumps(record)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line)

    def close(self):
        if self._f:
            self._f.close()


class StageTimer:
    """Accumulating per-stage wall-clock timer (tic/toc, but structured)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_s": round(self.totals[k] / max(self.counts[k], 1), 4),
            }
            for k in self.totals
        }
