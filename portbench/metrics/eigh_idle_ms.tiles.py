"""Device idle inside each ``svt.eigh`` span (cuSOLVER's batched ``eigh``
of one lockstep step, its host sync and two copies), averaged over the
spans of the traced stretch."""

from yardstick import spans


def read(run):
    found = [] if run.trace is None else spans.named(run.trace, "svt.eigh")
    return spans.idle_ns(run.trace, found) / 1e6 / len(found) if found else None
