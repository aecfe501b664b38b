"""The outer steps' wall time (``Solver.run``'s ``history["seconds"]``) over
their DIP iterations (``history["dip_iters"]``), summed over the window."""


def read(run):
    seconds = sum(sum(r.info.get("seconds", ())) for r in run.records)
    iters = sum(sum(r.info.get("dip_iters", ())) for r in run.records)
    return 1e3 * seconds / iters if iters else None
