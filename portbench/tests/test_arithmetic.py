"""The yardstick's arithmetic: rates and tails over every request and the
whole window, B1's bound, skip-128's operations, the trace's busy union."""

import math

import pytest

import run
from reference import skip128
from traffic.base import Record
from yardstick import b1, peaks, trace as tr


def _run(records, window_s, **kw):
    return run.Run(records=records, window_s=window_s, **kw)


def _records(latencies, tiles=1, steps=2):
    t, out = 0.0, []
    for lat in latencies:
        out.append(Record(t, t + lat, tiles=tiles, steps=steps, info={}))
        t += lat
    return out


def test_rate_is_every_tile_over_the_whole_window():
    recs = _records([0.1] * 9 + [1.0], tiles=16)
    r = _run(recs, window_s=2.5)
    assert run.load_metric("tiles_per_s")(r) == pytest.approx(160 / 2.5)


def test_step_time_is_the_whole_window_over_every_step():
    recs = [Record(0, 5, 0, 10, {}), Record(5, 11, 0, 10, {})]
    assert run.load_metric("step_ms")(_run(recs, window_s=11.0)) == pytest.approx(550.0)


def test_tail_is_over_every_request():
    lat = [0.010] * 90 + [0.100] * 10
    p90 = run.load_metric("solve_ms_p90")(_run(_records(lat), window_s=sum(lat)))
    # linear interpolation between the 90th and 91st of 100 sorted latencies
    assert 10.0 < p90 <= 100.0
    assert p90 == pytest.approx(10.0 + 0.1 * 90.0)
    assert run.load_metric("solve_ms_p90")(_run(_records([0.01] * 99 + [9.0]), window_s=10)) == pytest.approx(10.0)


def test_dip_metrics_sum_over_the_window():
    recs = [Record(0, 1, 0, 2, {"seconds": [0.5, 0.6], "dip_iters": [170, 200]}),
            Record(1, 2, 0, 2, {"seconds": [0.5, 0.5], "dip_iters": [180, 190]})]
    r = _run(recs, window_s=2.0)
    assert run.load_metric("dip_iter_ms")(r) == pytest.approx(1e3 * 2.1 / 740)
    assert run.load_metric("dip_iters_per_step")(r) == pytest.approx(185.0)


def test_b1_bound_at_the_main_shape():
    h = peaks.H100_SXM
    assert b1.bound_s(144, 1296, 512, 100, "float32", h) * 1e3 == pytest.approx(0.5705, abs=5e-5)
    assert b1.bound_s(144, 1296, 512, 100, "bfloat16", h) * 1e3 == pytest.approx(0.0386, abs=5e-5)
    assert b1.is_b1_kernel("void pnp_ista_panel<false>(PanelArgs)") and not b1.is_b1_kernel("gemm")


def test_skip128_operations_match_a_hand_count_of_the_innermost_level():
    layers = {name: layer for name, *layer in skip128.conv_layers(36, 36, 128)}
    inner = "_SkipScale_0." * 5
    # innermost scale: a 3x3 map (36 -> 18 -> 9 -> 5 -> 3), down to 2x2, up to 4x4,
    # cropped to 3x3 beside the 1x1 skip conv
    assert layers[inner + "Conv2d_0"] == [128, 128, 3, 2, 2, True]
    assert layers[inner + "Conv2d_1"] == [128, 128, 3, 2, 2, True]
    assert layers[inner + "Conv2d_2"] == [128, 128, 1, 3, 3, True]
    assert layers[inner + "Conv2d_3"] == [256, 128, 3, 3, 3, True]
    assert layers[inner + "Conv2d_4"] == [128, 128, 1, 3, 3, True]
    fwd = sum(2 * cin * cout * k * k * h * w
              for (cin, cout, k, h, w, _) in (layers[inner + f"Conv2d_{i}"] for i in range(5)))
    hand = 2 * (128 * 128 * 9 * 4 * 2 + 128 * 128 * 9 + 256 * 128 * 9 * 9 + 128 * 128 * 9)
    assert fwd == hand
    total = skip128.fit_flops_per_iteration(36, 36, 128)
    fwd_all = sum(2 * cin * cout * k * k * h * w for (cin, cout, k, h, w, _) in layers.values())
    outer_inputs = sum(2 * cin * cout * k * k * h * w for (cin, cout, k, h, w, g) in layers.values() if not g)
    assert total == 3 * fwd_all - outer_inputs
    assert 1.4e9 < fwd_all < 1.5e9


def test_skip128_spec_matches_the_ports_net():
    import program  # noqa: F401  (puts the port on the path)
    from lrs_pnp_dip_tpu_torch.models import dip_skip_128

    sd = dip_skip_128(num_channels=16).state_dict()
    spec = skip128.param_spec(16)
    assert sorted(k for k, _, _ in spec) == sorted(sd)
    assert all(tuple(sd[k].shape) == shape for k, shape, _ in spec)


def test_busy_union_and_idle_gaps():
    dev = [tr.Interval("a", 0, 10), tr.Interval("b", 5, 20), tr.Interval("a", 30, 40), tr.Interval("c", 35, 36)]
    host = [tr.Interval("aten::linalg_eigh", 18, 32), tr.Interval("cudaStreamSynchronize", 21, 31)]
    t = tr.Trace(dev, host, 50)
    assert tr.busy_intervals(dev) == [[0, 20], [30, 40]]
    assert tr.busy_ns(dev) == 30
    assert tr.idle_gaps(t) == [["aten::linalg_eigh > cudaStreamSynchronize", 10 / 1e9]]
    assert tr.top_device_ops(dev)[0] == ["a", 20 / 1e9]
    assert tr.device_time_ns(dev, lambda n: n == "b") == 15


def test_shares_stay_silent_without_their_source():
    from yardstick import shares

    r = _run([], window_s=1.0, peaks=None, flops=10, trace=None, b1_work=[], config={})
    assert shares.mfu_pct(r) is None and shares.idle_pct(r) is None and shares.b1_roofline_pct(r) is None
    assert run.load_metric("mfu_pct.step_bf16")(r) is None
    r = _run([], window_s=2.0, peaks=peaks.H100_SXM, flops=67e12, trace=None, b1_work=[], config={})
    assert shares.mfu_pct(r) == pytest.approx(50.0)
    assert math.isfinite(shares.mfu_pct(r))
    assert run.load_metric("mfu_pct.step_bf16")(r) == pytest.approx(100.0 * 67e12 / (2.0 * 989e12))
