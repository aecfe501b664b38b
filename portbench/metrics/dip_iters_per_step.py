"""DIP iterations per outer step over the window (``history["dip_iters"]``):
the fit's work, so that a change to its early stop shows as work and not
as speed."""


def read(run):
    iters = [n for r in run.records for n in r.info.get("dip_iters", ())]
    return sum(iters) / len(iters) if iters else None
