"""Host time a scene spends on its tiles' constants (the ``tiles.consts``
spans: ``make_consts`` of each tile, the step sizes' power iterations
among them, and the stacked constants and states), in the traced stretch."""

from yardstick import spans


def read(run):
    found = [] if run.trace is None else spans.named(run.trace, "tiles.consts")
    return spans.total_ns(found) / 1e6 / run.cell["trace_requests"] if found else None
