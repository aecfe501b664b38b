"""Profiler hooks (counterpart of ``lrs_pnp_dip_tpu/utils/profiling.py``, on
``torch.profiler`` in place of ``jax.profiler``).

``trace(log_dir)`` records the enclosed block, the host's operators and,
where a card is present, its kernels, and writes a Chrome trace
(``trace_<time>_<pid>.json``, for Perfetto or chrome://tracing) into
``log_dir``; ``annotate(name)`` names a region of it.

``annotate`` is the port's one span API.  While a ``torch.profiler``
session records on the calling thread, a span is a record function of the
operators' scope: a host event in the kineto trace, stamped on the clock
that kineto maps the card's kernel timestamps onto, so a span and the
kernels launched inside it line up.  Otherwise a span is a shared no-op
context, and costs one check of the profiler's flag.

The two private torch APIs below (``_RecordFunctionFast`` and
``_profiler_enabled``) are a workaround.  The public ``record_function``
records in the user scope, and on the card kineto then adds a
``gpu_user_annotation`` over the kernels each span launched: a CUDA event
that a trace reader which takes every CUDA event for device work counts as
busy, which hides the card's idle time.  Once such readers keep kernels,
copies and sets only, the public API behind the same flag check will do.
A trace made with ``trace()`` therefore shows a span as a host row only,
with no device-side annotation row.

The port places spans at the host side of its layer boundaries, never
inside a function that a CUDA graph captures (a span there would fire only
at warm-up and capture).  This list is the one record of their names:

  * tile pipeline: ``tiles.wait`` (the next batch of tiles from the
    loader's thread), ``tiles.consts`` (the call's dictionary upload, and
    each batch's constants and initial states: two uploads and one build),
    ``tiles.stitch`` (each batch's tiles added into the scene's float64
    sum on the device, and the call's final divide), ``tiles.readback``
    (the call's one copy of the float32 scene to the host);
  * outer step: ``step.graph_a``, ``step.graph_b`` and ``step.history_read``
    of the device-resident loop; ``step.sparse``, ``step.finish`` and
    ``step.read`` of the host-stepped one;
  * low-rank prox: ``svt.eigh`` (cuSOLVER's ``eigh``, which ends in a host
    sync); ``dip.fit`` (a DIP fit, whole) and ``dip.flag_read`` (each read
    of its stop flag).

Counters beside the spans, read outside any timed region:
``_TileEngine.placed`` and ``_TileEngine.readbacks`` (``solvers/tiled.py``:
the tiles the latest scene solve added into its sum on the device, and its
copies of the scene to the host, one a call),
``DipFit.flag_reads`` (stop-flag reads of the latest fit),
``ISTA_KERNEL.launches_by_kernel`` (kernel B1's launches by kernel),
``SN_KERNEL.launches`` (launches of the spectral norm kernel,
``ops/spectral_norm_cuda.py``: one a forward of the 1-Lip U-Net on the
card, replays of a captured fit included), and
``LipschitzUNet.power_products`` (the matrix-vector products its spectral
norms run per forward, derived from its modules, inside that one launch on
the card).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile

_NO_SPAN = contextlib.nullcontext()


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
    """A span named ``name`` while a profiler records on this thread, else
    a shared no-op context."""
    if torch._C._autograd._profiler_enabled():
        return _RecordFunctionFast(name)
    return _NO_SPAN
