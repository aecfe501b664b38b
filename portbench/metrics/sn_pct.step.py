"""The share of the device time inside the ``dip.fit`` spans of the traced
stretch that the 1-Lip net's spectral norms spend in their matrix-vector
products and two-norm reductions: ``power_products`` of each (the
program's counter, in the records' ``info``) a forward, one forward a
replayed iteration.

The kernels are picked by name (:func:`is_sn_kernel`): torch's two-norm
reductions (``NormTwoOps``), and cuBLAS's real matrix-vector kernels, which
at the net's shapes are ``gemv`` kernels or, for some, a ``dot_kernel``
followed by a ``reduce_1Block_kernel`` (on the H100 with the card's
cuBLAS: 158 and 80 of the 238 products a forward).  cuDNN's FFT
convolutions run complex ``gemv`` kernels (``float2``) in both DIP nets,
which the rule leaves out.  The share is a lower bound: the products'
``reduce_1Block_kernel`` halves, and the divides and adds that normalise
each vector, are not picked.  The reader returns None unless the rule
matches 2 x ``power_products`` kernels per replayed iteration (the graph
launches inside the spans) to within ``COUNT_SLACK``, so that a rule gone
stale, or a library that splits a product another way, reads as absent
and not as a wrong share; and None where the program does not count its
products.  The slack is for the profiler, not the rule: a traced stretch
holds about a million device records, and one of three traced runs on the
card lost 0.44% of the fit's operations (1,488.9 an iteration against
1,495.4, its buffers flushed mid-stretch), while the smallest stale rule
seen in the names, one cuBLAS kernel variant missed, is off by 3.8%."""

from yardstick import spans

COUNT_SLACK = 0.02  # of 2 x power_products a replayed iteration


def is_sn_kernel(name: str) -> bool:
    if "float2" in name:  # cuDNN's FFT convolutions
        return False
    return "NormTwoOps" in name or "gemv" in name or "dot_kernel" in name


def read(run):
    products = next((r.info.get("power_products") for r in run.records
                     if r.info.get("power_products")), None)
    if run.trace is None or not products:
        return None
    found = spans.named(run.trace, "dip.fit")
    iters = spans.calls_inside(run.trace, found, "cudaGraphLaunch".__eq__) if found else 0
    ops = spans.inside(run.trace.device, found)
    sn = [iv for iv in ops if is_sn_kernel(iv.name)]
    if not iters or abs(len(sn) / iters - 2 * products) > COUNT_SLACK * 2 * products:
        return None
    return 100.0 * spans.total_ns(sn) / spans.total_ns(ops)
