"""The share of the DIP fits' time (the ``dip.fit`` spans of the traced
stretch) in which the device ran nothing: the stop flag's reads and the
launches of each chunk of iterations after them."""

from yardstick import spans


def read(run):
    found = [] if run.trace is None else spans.named(run.trace, "dip.fit")
    total = spans.total_ns(found)
    return 100.0 * spans.idle_ns(run.trace, found) / total if total else None
