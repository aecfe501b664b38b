"""Profiler hooks (counterpart of ``lrs_pnp_dip_tpu/utils/profiling.py``, on
``torch.profiler`` in place of ``jax.profiler``).

``trace(log_dir)`` records the enclosed block, the host's operators and,
where a card is present, its kernels, and writes a Chrome trace
(``trace_<time>_<pid>.json``, for Perfetto or chrome://tracing) into
``log_dir``; ``annotate(name)`` names a region of it.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into ``log_dir``;
    yields the profiler (``key_averages()`` for sums by operator)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name: str):
    """Named trace annotation for a code region (shows in the timeline)."""
    return record_function(name)
