"""The window's length over the outer steps completed in it."""


def read(run):
    steps = sum(r.steps for r in run.records)
    return 1e3 * run.window_s / steps if steps else None
