"""The DIP fits' pace: the time inside the ``dip.fit`` spans of the traced
stretch over the graph launches inside them, one per replayed iteration."""

from yardstick import spans


def read(run):
    found = [] if run.trace is None else spans.named(run.trace, "dip.fit")
    iters = spans.calls_inside(run.trace, found, "cudaGraphLaunch".__eq__) if found else 0
    return spans.total_ns(found) / 1e6 / iters if iters else None
