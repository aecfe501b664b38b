"""Reads of the DIP fit's stop flag per fit (one fit an outer step): the
``dip.flag_read`` spans over the ``dip.fit`` spans of the traced stretch."""

from yardstick import spans


def read(run):
    if run.trace is None:
        return None
    fits = spans.named(run.trace, "dip.fit")
    return len(spans.named(run.trace, "dip.flag_read")) / len(fits) if fits else None
