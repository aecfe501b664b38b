"""The readers of the program's spans, on a hand-made trace: each returns the
value worked out by hand, and None when its span is absent, as in a trace
of a program that places no span."""

import pytest

import run
from yardstick import spans
from yardstick.trace import Interval, Trace

MS = 1_000_000  # ns


def _iv(name, start_ms, end_ms):
    return Interval(name, int(start_ms * MS), int(end_ms * MS))


def _tiles_trace():
    """Two scenes' worth of spans: constants 0-10 and 20-26 ms with three and
    two launches inside (one more outside), an ``eigh`` 30-40 ms whose device
    runs 32-35 and 37-39, a second 50-52 ms wholly busy, readbacks of 1 ms
    and stitches of 2 ms."""
    host = [
        _iv("tiles.consts", 0, 10), _iv("cudaLaunchKernel", 1, 1.1), _iv("cudaLaunchKernelExC", 2, 2.1),
        _iv("cuLaunchKernel", 9, 9.5), _iv("tiles.consts", 20, 26), _iv("cudaLaunchKernel", 21, 21.1),
        _iv("cudaLaunchKernel", 25, 25.2), _iv("cudaLaunchKernel", 27, 27.1), _iv("aten::mm", 3, 4),
        _iv("svt.eigh", 30, 40), _iv("svt.eigh", 50, 52),
        _iv("tiles.readback", 41, 42), _iv("tiles.stitch", 42, 44), _iv("tiles.readback", 60, 61),
        _iv("tiles.stitch", 61, 63), _iv("tiles.stitch", 63, 65),
    ]
    device = [_iv("syevbj_batch", 32, 35), _iv("row_rotate", 34, 35), _iv("column_rotate", 37, 39),
              _iv("gemm", 48, 53), _iv("panel", 100, 110)]
    return Trace(device, host, 120 * MS)


def _dip_trace():
    """Two fits, 0-20 and 30-40 ms: four and three graph launches, three and
    two flag reads; the device runs 0-8, 9-19 and 30-38 ms, and 45-50 outside
    any fit."""
    host = [_iv("dip.fit", 0, 20), _iv("dip.fit", 30, 40), _iv("cudaGraphLaunch", 50, 51)]
    host += [_iv("cudaGraphLaunch", t, t + 0.1) for t in (1, 5, 9, 13, 31, 34, 37)]
    host += [_iv("dip.flag_read", t, t + 0.5) for t in (8, 16, 19, 35, 39)]
    device = [_iv("conv", 0, 8), _iv("conv", 9, 19), _iv("adam", 30, 38), _iv("conv", 45, 50)]
    return Trace(device, host, 60 * MS)


def _run(trace, requests=2):
    return run.Run(trace=trace, cell={"trace_requests": requests})


@pytest.mark.parametrize("name, value", [
    ("consts_ms.tiles", 16.0 / 2),
    ("consts_launches.tiles", 5 / 2),
    ("eigh_idle_ms.tiles", ((10 - 3 - 2) + 0.0) / 2),
    ("stitch_ms.tiles", (1 + 2 + 1 + 2 + 2) / 2),
])
def test_tile_readers(name, value):
    assert run.load_metric(name)(_run(_tiles_trace())) == pytest.approx(value)


@pytest.mark.parametrize("name, value", [
    ("fit_iter_ms.step", 30.0 / 7),
    ("fit_idle_pct.step", 100.0 * (2 + 2) / 30),
    ("flag_reads.step", 5 / 2),
])
def test_fit_readers(name, value):
    assert run.load_metric(name)(_run(_dip_trace())) == pytest.approx(value)


@pytest.mark.parametrize("name", [
    "consts_ms.tiles", "consts_launches.tiles", "eigh_idle_ms.tiles", "stitch_ms.tiles",
    "fit_iter_ms.step", "fit_idle_pct.step", "flag_reads.step",
])
def test_readers_are_none_without_their_spans(name):
    """The program before the spans: operators, launches and device time
    alone; and no traced stretch at all."""
    bare = Trace([_iv("conv", 0, 8)], [_iv("aten::mm", 0, 1), _iv("cudaLaunchKernel", 0.2, 0.3),
                                       _iv("cudaGraphLaunch", 2, 2.1)], 10 * MS)
    assert run.load_metric(name)(_run(bare)) is None
    assert run.load_metric(name)(_run(None)) is None


def test_idle_inside_spans_counts_overlapping_device_work_once():
    trace = Trace([_iv("a", 0, 4), _iv("b", 2, 6), _iv("c", 8, 9)], [_iv("s", 1, 10)], 10 * MS)
    assert spans.idle_ns(trace, spans.named(trace, "s")) == 3 * MS
    assert spans.inside([_iv("x", 1, 10), _iv("y", 0, 2)], spans.named(trace, "s")) == [_iv("x", 1, 10)]
