"""The readers of the program's spans, on a hand-made trace: each returns the
value worked out by hand, and None when its span is absent, as in a trace
of a program that places no span."""

import pytest

import run
from traffic.base import Record
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


# -- the spectral norm's share ----------------------------------------------------


def _sn_trace(launches=(1, 9, 31), per_launch=1, name="void sn_power_cluster<8>(SnArgs)"):
    """Two fits, 0-20 and 30-40 ms, with a graph launch at each of
    ``launches``; each replayed iteration runs ``per_launch`` cluster
    kernels of 0.05 ms and three convolutions of 0.15 ms inside the spans;
    one more cluster kernel lies outside them."""
    host = [_iv("dip.fit", 0, 20), _iv("dip.fit", 30, 40), _iv("cudaGraphLaunch", 50, 51)]
    host += [_iv("cudaGraphLaunch", t, t + 0.1) for t in launches]
    device = [_iv(name, 45, 46)]
    for t in launches:
        device += [_iv(name, t + 0.2 + 0.06 * j, t + 0.25 + 0.06 * j) for j in range(per_launch)]
        device += [_iv(f"sm80_xmma_fprop_{k}", t + 1 + 0.2 * k, t + 1.15 + 0.2 * k) for k in range(3)]
    return Trace(device, host, 60 * MS)


def _records(products):
    return [Record(0.0, 1.0, tiles=0, steps=1, info={"dip_iters": [3], "power_products": products})]


@pytest.mark.parametrize("products", [238, None])
def test_sn_share_reads_the_cluster_kernel_once_a_replayed_iteration(products):
    """The port's one spectral norm launch a forward: its share of the fit's
    device time, whether or not the program counts its products."""
    read = run.load_metric("sn_pct.step")
    got = read(run.Run(trace=_sn_trace(), records=_records(products)))
    assert got == pytest.approx(100.0 * 0.05 / (0.05 + 3 * 0.15), rel=1e-4)


def test_sn_share_is_none_where_the_cluster_count_is_off():
    read = run.load_metric("sn_pct.step")
    assert read(run.Run(trace=_sn_trace(per_launch=2), records=_records(238))) is None  # two a forward
    lost = _sn_trace(launches=tuple(range(1, 20)) + (31, 33, 35, 37, 39))
    cluster = [iv for iv in lost.device if "sn_power_cluster" in iv.name]
    one_lost = Trace([iv for iv in lost.device if iv is not cluster[5]], lost.host, lost.window_ns)
    assert read(run.Run(trace=one_lost, records=_records(238))) is None  # 23 of 24: past the 2% slack
    lots = _sn_trace(launches=tuple(0.5 + 0.3 * k for k in range(60)))  # 60 launches in the first fit
    cluster = [iv for iv in lots.device if "sn_power_cluster" in iv.name]
    profiler_lost_one = Trace([iv for iv in lots.device if iv is not cluster[10]], lots.host, lots.window_ns)
    assert read(run.Run(trace=profiler_lost_one, records=_records(238))) is not None  # 59 of 60: inside the slack
    assert read(run.Run(trace=None, records=_records(238))) is None


def test_sn_share_is_none_for_the_skip128_fit():
    """skip-128 runs no spectral norm and counts no products."""
    read = run.load_metric("sn_pct.step")
    assert read(run.Run(trace=_dip_trace(), records=_records(None))) is None
    assert read(run.Run(trace=_dip_trace(), records=_records(238))) is None  # no library kernel either


# -- device work in a profile -------------------------------------------------------


class _Event:
    """A kineto event as ``torch.profiler`` hands it over: ``kind`` None is a
    torch without ``activity_type``."""

    def __init__(self, name, start_ms, end_ms, device, kind=None, annotation=False):
        self._v = (name, int(start_ms * MS), int(end_ms * MS), device, annotation)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return f"DeviceType.{self._v[3]}"

    def is_user_annotation(self):
        return self._v[4]


def _profile(events):
    results = type("R", (), {"events": lambda self: events})()
    return type("P", (), {"profiler": type("K", (), {"kineto_results": results})()})()


@pytest.mark.parametrize("with_kind", [True, False], ids=["activity_type", "no_activity_type"])
def test_a_spans_gpu_annotation_is_never_device_work(with_kind):
    """A user span over 0-10 ms puts a ``gpu_user_annotation`` over the
    kernels it launched (2-3 and 7-8 ms) on the device's timeline: busy is
    the kernels' 2 ms and the copy's 1 ms, not the annotation's 8 ms."""
    from yardstick import trace as tr

    def k(kind):
        return kind if with_kind else None

    events = [
        _Event("user.span", 0, 10, "CPU", k("user_annotation"), annotation=True),
        _Event("aten::mm", 1, 2, "CPU", k("cpu_op")),
        _Event("cudaLaunchKernel", 1.5, 1.6, "CPU", k("cuda_runtime")),
        _Event("user.span", 2, 10, "CUDA", k("gpu_user_annotation"), annotation=True),
        _Event("sm90_gemm", 2, 3, "CUDA", k("kernel")),
        _Event("sm90_gemm", 7, 8, "CUDA", k("kernel")),
        _Event("Memcpy DtoH", 9, 10, "CUDA", k("gpu_memcpy")),
    ]
    trace = tr.from_profile(_profile(events), 12 * MS)
    assert sorted(iv.name for iv in trace.device) == ["Memcpy DtoH", "sm90_gemm", "sm90_gemm"]
    assert tr.busy_ns(trace.device) == 3 * MS
    assert {iv.name for iv in trace.host} == {"user.span", "aten::mm", "cudaLaunchKernel"}
