"""Host time a scene spends bringing its solved tiles back and stitching
them (the ``tiles.readback`` and ``tiles.stitch`` spans), in the traced
stretch."""

from yardstick import spans


def read(run):
    if run.trace is None:
        return None
    found = spans.named(run.trace, "tiles.readback") + spans.named(run.trace, "tiles.stitch")
    return spans.total_ns(found) / 1e6 / run.cell["trace_requests"] if found else None
