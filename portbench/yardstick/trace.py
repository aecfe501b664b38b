"""What the device did in a traced stretch, from ``torch.profiler``'s events.

Busy time is the union of the intervals in which a device operation ran
(kernels, copies, sets), as ``scripts/profile_port_step.py`` takes it: a
kernel that overlaps another adds only the part that no earlier one covered.
The idle gaps between them are named by what the host was doing at their
middle: the outermost and the innermost host event that spans that instant.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Interval(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Trace(NamedTuple):
    device: list  # [Interval] device operations
    host: list  # [Interval] host events (operators, runtime calls, annotations)
    window_ns: int  # the traced stretch's length by the host clock


def _kind(event) -> str:
    """The event's kind as kineto names it.  A torch without
    ``activity_type`` is told a device event by its device type; a span's
    ``gpu_user_annotation`` (a user annotation on the device's timeline,
    which covers the kernels its span launched and is no device work
    itself) is never a kernel, with or without ``activity_type``."""
    kind = getattr(event, "activity_type", None)
    on_device = "CUDA" in str(event.device_type())
    annotation = getattr(event, "is_user_annotation", None)
    if on_device and annotation is not None and annotation():
        return "gpu_user_annotation"
    if kind is not None:
        return str(kind())
    return "kernel" if on_device else "cpu_op"


def from_profile(prof, window_ns: int) -> Trace:
    """Split a finished ``torch.profiler.profile``'s raw events."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        iv = Interval(e.name(), int(e.start_ns()), int(e.end_ns()))
        if iv.end_ns <= iv.start_ns:
            continue
        if kind in _DEVICE_KINDS:
            device.append(iv)
        elif kind in ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"):
            host.append(iv)
    return Trace(device, host, int(window_ns))


def busy_intervals(device: list) -> list:
    """The union of the device intervals, as sorted disjoint (start, end)."""
    merged = []
    for s, e in sorted((iv.start_ns, iv.end_ns) for iv in device):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def busy_ns(device: list) -> int:
    return sum(e - s for s, e in busy_intervals(device))


def device_time_ns(device: list, match) -> int:
    """Summed device time of the operations whose name ``match`` accepts."""
    return sum(iv.end_ns - iv.start_ns for iv in device if match(iv.name))


def top_device_ops(device: list, n: int = 10) -> list:
    """[[name, seconds]] of the ``n`` device operations with the most time."""
    by = collections.Counter()
    for iv in device:
        by[_short(iv.name)] += iv.end_ns - iv.start_ns
    return [[name, ns / 1e9] for name, ns in by.most_common(n)]


def idle_gaps(trace: Trace, n: int = 10) -> list:
    """[[host activity, seconds]]: the idle time between device operations,
    summed by what the host was doing at the middle of each gap, the ``n``
    largest."""
    busy = busy_intervals(trace.device)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    host = sorted(trace.host, key=lambda iv: iv.start_ns)
    by = collections.Counter()
    active, i = [], 0
    for s, e in gaps:  # in order of time: a sweep over the host events
        mid = (s + e) // 2
        while i < len(host) and host[i].start_ns <= mid:
            active.append(host[i])
            i += 1
        active = [iv for iv in active if iv.end_ns >= mid]
        if active:
            outer = max(active, key=lambda iv: iv.end_ns - iv.start_ns)
            inner = min(active, key=lambda iv: iv.end_ns - iv.start_ns)
            name = _short(outer.name) if outer is inner else f"{_short(outer.name)} > {_short(inner.name)}"
        else:
            name = "host outside any traced event"
        by[name] += e - s
    return [[name, ns / 1e9] for name, ns in by.most_common(n)]


def _short(name: str, limit: int = 96) -> str:
    return name if len(name) <= limit else name[: limit - 3] + "..."
