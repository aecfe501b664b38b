"""Device operations a replayed DIP iteration runs: the device operations
inside the ``dip.fit`` spans of the traced stretch over the graph launches
inside them (one a replayed iteration, as ``fit_iter_ms.step`` counts
them).  A fit's few operations outside its graph (the input's and the
initial weights' copies, the stop flag's reads) are spread over its
iterations; at 100 to 300 iterations a fit they add well under one an
iteration.  The lever a fusion of the fit's small kernels moves."""

from yardstick import spans


def read(run):
    found = [] if run.trace is None else spans.named(run.trace, "dip.fit")
    iters = spans.calls_inside(run.trace, found, "cudaGraphLaunch".__eq__) if found else 0
    return len(spans.inside(run.trace.device, found)) / iters if iters else None
