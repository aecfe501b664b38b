"""The share of the device time inside the ``dip.fit`` spans of the traced
stretch that the 1-Lip net's spectral norms take.

On the card the port runs the 14 spectral norms of a forward as one launch
of its cluster kernel, ``sn_power_cluster<C>`` (``csrc/spectral_norm.cu``),
and a replayed iteration runs one forward: the reader picks the device
operations whose name holds ``sn_power_cluster`` and reads their share only
where they number one per replayed iteration (the graph launches inside the
spans) to within ``COUNT_SLACK``.

A program without that kernel runs the power iterations through library
calls, ``power_products`` matrix-vector products and as many two-norms a
forward (the program's counter, in the records' ``info``).  Where no
cluster kernel ran, the reader picks those by :func:`is_sn_kernel`: torch's
two-norm reductions (``NormTwoOps``) and cuBLAS's real matrix-vector
kernels, ``gemv`` or a ``dot_kernel`` (followed by a ``reduce_1Block_kernel``
that the rule leaves out, so that share is a lower bound), but not cuDNN's
complex ``gemv`` (``float2``) of its FFT convolutions; it reads only where
they number 2 x ``power_products`` per replayed iteration.

Otherwise the reader returns None, so that a rule gone stale, or a library
that splits a product another way, reads as absent and not as a wrong share.
The slack is for the profiler, not the rule: a traced stretch holds about a
million device records, and one of three traced runs on the card lost 0.44%
of the fit's operations (its buffers flushed mid-stretch), while the
smallest stale library rule seen in the names, one cuBLAS kernel variant
missed, is off by 3.8%."""

from yardstick import spans

COUNT_SLACK = 0.02  # of the expected kernels a replayed iteration
CLUSTER_KERNEL = "sn_power_cluster"


def is_sn_kernel(name: str) -> bool:
    """The library rule: a kernel of the plain power iteration."""
    if "float2" in name:  # cuDNN's FFT convolutions
        return False
    return "NormTwoOps" in name or "gemv" in name or "dot_kernel" in name


def read(run):
    if run.trace is None:
        return None
    found = spans.named(run.trace, "dip.fit")
    iters = spans.calls_inside(run.trace, found, "cudaGraphLaunch".__eq__) if found else 0
    ops = spans.inside(run.trace.device, found)
    sn = [iv for iv in ops if CLUSTER_KERNEL in iv.name]
    per_iter = 1
    if not sn:
        per_iter = 2 * next((r.info.get("power_products") for r in run.records
                             if r.info.get("power_products")), 0)
        sn = [iv for iv in ops if is_sn_kernel(iv.name)]
    if not iters or not per_iter or abs(len(sn) / iters - per_iter) > COUNT_SLACK * per_iter:
        return None
    return 100.0 * spans.total_ns(sn) / spans.total_ns(ops)
