"""The program's spans in a traced stretch, and what lies inside them.

A span is a host event that the program records while the profiler runs
(a record function of the operators' scope, or a ``user_annotation``);
:func:`.trace.from_profile` keeps it among the host events, on the clock of
the device's intervals.  The program's span names (``tiles.consts``,
``svt.eigh``, ``dip.fit``, ...) hold a dot, which no operator or runtime
call does.
"""

from __future__ import annotations

import bisect

from .trace import Trace, busy_intervals

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")  # prefixes of the runtime's and the driver's launch calls


def named(trace: Trace, name: str) -> list:
    """The spans called ``name``, in order of their start."""
    return sorted((iv for iv in trace.host if iv.name == name), key=lambda iv: iv.start_ns)


def total_ns(spans: list) -> int:
    return sum(iv.end_ns - iv.start_ns for iv in spans)


def inside(events: list, spans: list) -> list:
    """The events that lie wholly inside one of ``spans``, which do not
    overlap one another."""
    spans = sorted(spans, key=lambda iv: iv.start_ns)
    starts = [iv.start_ns for iv in spans]
    found = []
    for ev in events:
        k = bisect.bisect_right(starts, ev.start_ns) - 1
        if k >= 0 and ev.end_ns <= spans[k].end_ns:
            found.append(ev)
    return found


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCHES)


def calls_inside(trace: Trace, spans: list, match) -> int:
    """Host events whose name ``match`` accepts, inside ``spans``."""
    return len(inside([iv for iv in trace.host if match(iv.name)], spans))


def idle_ns(trace: Trace, spans: list) -> int:
    """The time inside ``spans`` in which no device operation ran."""
    busy = busy_intervals(trace.device)
    ends = [e for _, e in busy]
    idle = 0
    for sp in spans:
        covered = 0
        k = bisect.bisect_right(ends, sp.start_ns)
        while k < len(busy) and busy[k][0] < sp.end_ns:
            covered += min(busy[k][1], sp.end_ns) - max(busy[k][0], sp.start_ns)
            k += 1
        idle += sp.end_ns - sp.start_ns - covered
    return idle
