"""Structured metric logging (jsonl), as ``lrs_pnp_dip_tpu/utils/logging.py``
logs.

The reference's observability is stdout prints and MATLAB-style tic/toc
globals (``main_LRS_PnP_DIP_pro.py:41-52``).  Here: a jsonl metric writer
stamped with the host's wall clock.  The tic/toc stages are the spans of
:func:`.profiling.annotate`, which a ``torch.profiler`` trace times on the
card's clock.
"""

from __future__ import annotations

import json
import time
from typing import Optional


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
