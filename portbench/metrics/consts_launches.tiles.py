"""Kernel launches a scene makes for its tiles' constants: the launch calls
inside the ``tiles.consts`` spans of the traced stretch, per scene."""

from yardstick import spans


def read(run):
    found = [] if run.trace is None else spans.named(run.trace, "tiles.consts")
    return spans.calls_inside(run.trace, found, spans.is_launch) / run.cell["trace_requests"] if found else None
