"""The shares that several metrics take, from a run's window and trace."""

from __future__ import annotations

from . import b1
from . import trace as tr


def mfu_pct(run):
    """The window's counted operations over its length times the card's
    f32 peak, in percent; None off a card the peak table holds."""
    if run.peaks is None or run.window_s <= 0 or not run.flops:
        return None
    return 100.0 * run.flops / (run.window_s * run.peaks["f32_flops"])


def idle_pct(run):
    """The share of the traced stretch in which no device operation ran."""
    if run.trace is None or not run.trace.device or run.trace.window_ns <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_ns(run.trace.device) / run.trace.window_ns)


def b1_roofline_pct(run):
    """B1's least time for the traced stretch's work over the device time
    of its kernels there, in percent."""
    if run.trace is None or run.peaks is None or not run.b1_work:
        return None
    spent_ns = tr.device_time_ns(run.trace.device, b1.is_b1_kernel)
    if spent_ns <= 0:
        return None
    dtype = run.config["solver"]["sparse"]["matmul_dtype"]
    least_s = sum(b1.bound_s(*shape, dtype, run.peaks) for shape in run.b1_work)
    return 100.0 * least_s / (spent_ns / 1e9)
