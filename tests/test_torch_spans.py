"""The port's spans (``utils/profiling.annotate``) on the CPU.

  * With no profiler recording, a span is a shared no-op context and never
    makes a record function; under the profiler it is a host event of the
    operators' scope, so kineto adds no device-side annotation for it.
  * Under ``torch.profiler``, a tiled `lrs_pnp` scene (72x72x8, 36x36 tiles,
    ``tile_batch`` 2, 2 outer steps, the device-resident loop) yields each
    ``tiles.*``, ``step.*`` and ``svt.eigh`` span as often as its call site
    runs, and every operator that the batch's constant build
    (``assemble_consts``) issues lies inside a ``tiles.consts`` span: spans
    and operators share one clock.
  * A host-stepped `dip` step yields one ``dip.fit`` span holding as many
    ``dip.flag_read`` spans as ``DipFit.flag_reads`` counts.
  * The answers are the same bits with the profiler on and off.

Small problems: blocks of 4 (`lrs_pnp`) and 6 (`dip`), random dictionaries,
a skip net of a few channels.
"""

import collections
import dataclasses

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from lrs_pnp_dip_tpu_torch import inpaint_scene
from lrs_pnp_dip_tpu_torch.data import random_dictionary, synthetic_sample
from lrs_pnp_dip_tpu_torch.models import Skip
from lrs_pnp_dip_tpu_torch.solvers import Solver
from lrs_pnp_dip_tpu_torch.solvers import tiled as ttiled
from lrs_pnp_dip_tpu_torch.utils import config as tconfig
from lrs_pnp_dip_tpu_torch.utils import profiling

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

SPANS = {
    "tiles.wait", "tiles.consts", "tiles.readback", "tiles.stitch",
    "step.graph_a", "step.graph_b", "step.history_read", "step.sparse", "step.finish", "step.read",
    "svt.eigh", "dip.fit", "dip.flag_read",
}


def _events(prof):
    """[(name, start_ns, end_ns)] of every event the profile recorded."""
    return [(e.name(), int(e.start_ns()), int(e.end_ns())) for e in prof.profiler.kineto_results.events()]


def _span_counts(events):
    return collections.Counter(name for name, _, _ in events if name in SPANS)


def _intervals(events, name):
    return [(s, e) for n, s, e in events if n == name]


def _inside(interval, spans):
    s, e = interval
    return any(a <= s and e <= b for a, b in spans)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _events(prof)


def _scene():
    clean = synthetic_sample(72, 72, 8, missing=0.1, seed=5)
    cfg = tconfig.lrs_pnp_preset(
        block_size=4, stride=4, sparse=dataclasses.replace(tconfig.lrs_pnp_preset().sparse, n_iter=4)
    )
    return clean.noisy, clean.mask, random_dictionary(16, 32, seed=2), cfg


def _solve_scene(noisy, mask, D, cfg):
    return inpaint_scene(noisy, mask, config=cfg, dictionary=D, tile_shape=(36, 36), tile_batch=2, device="cpu")


def _dip_solver():
    base = tconfig.dip_preset()
    cfg = dataclasses.replace(
        base, block_size=6, stride=6, sparse=dataclasses.replace(base.sparse, n_iter=4),
        dip=dataclasses.replace(base.dip, num_iter=20, buffer_size=3, patience=2, learning_rate=0.01),
    )
    net = Skip(num_input_channels=16, num_output_channels=16, channels_down=(8, 8), channels_up=(8, 8),
               channels_skip=(4, 4), pad="reflection")
    rng = np.random.default_rng(0)
    D = rng.standard_normal((36, 48)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    return Solver(synthetic_sample(12, 12, 16, missing=0.1, seed=3), D, cfg, net=net, device="cpu")


def test_annotate_is_a_no_op_unless_a_profiler_records(monkeypatch):
    calls = []
    real = profiling._RecordFunctionFast

    def counted(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_RecordFunctionFast", counted)
    assert profiling.annotate("a") is profiling.annotate("b")
    with profiling.annotate("a"):
        pass
    solver = _dip_solver()
    solver.run(1)
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("recorded"):
            torch.ones(2).sum()
    assert calls == ["recorded"]
    (kind,) = [e.activity_type() for e in prof.profiler.kineto_results.events() if e.name() == "recorded"]
    assert kind == "cpu_op"


def test_scene_spans_count_their_call_sites_and_hold_make_consts(monkeypatch):
    """2 batches of 2 tiles, 2 outer steps each: the dictionary's upload in
    a constants span of its own; a wait, the constants and a stitch (the
    batch's tiles added into the scene's sum on the device) per batch, the
    final divide a third stitch, and one readback of the whole scene; graph
    A, ``eigh`` and graph B per step; one history read per batch.  Each
    batch's constants are one build over its stacked tiles.  The engine
    counts 4 tiles placed and 1 readback."""
    real = ttiled.assemble_consts

    def probed(*args, **kwargs):
        with record_function("probe.assemble_consts"):
            return real(*args, **kwargs)

    monkeypatch.setattr(ttiled, "assemble_consts", probed)
    noisy, mask, D, cfg = _scene()
    _, events = _profiled(lambda: _solve_scene(noisy, mask, D, cfg))
    assert _span_counts(events) == {
        "tiles.wait": 2, "tiles.consts": 3, "tiles.readback": 1, "tiles.stitch": 3,
        "step.graph_a": 4, "svt.eigh": 4, "step.graph_b": 4, "step.history_read": 2,
    }
    engine = ttiled._tiled_engine(cfg, (36, 36, 8), None, torch.device("cpu"))
    assert (engine.placed, engine.readbacks) == (4, 1)
    consts, probes = _intervals(events, "tiles.consts"), _intervals(events, "probe.assemble_consts")
    assert len(probes) == 2
    ops = [(s, e) for n, s, e in events if n.startswith("aten::") and _inside((s, e), probes)]
    assert len(ops) > 4 * tconfig.lrs_pnp_preset().sparse.power_iters
    assert all(_inside(op, consts) for op in ops)
    for name in ("step.graph_a", "svt.eigh", "step.graph_b"):
        assert not any(_inside(iv, consts) for iv in _intervals(events, name)), name


def test_dip_step_spans_count_the_flag_reads():
    solver = _dip_solver()
    _, events = _profiled(lambda: solver.run(1))
    reads = solver.stages.dip_fit.flag_reads
    assert reads > 1
    assert _span_counts(events) == {
        "step.sparse": 1, "dip.fit": 1, "dip.flag_read": reads, "step.finish": 1, "step.read": 1,
    }
    (fit,) = _intervals(events, "dip.fit")
    assert all(_inside(iv, [fit]) for iv in _intervals(events, "dip.flag_read"))


def test_answers_are_equal_bits_with_the_profiler_on_and_off():
    args = _scene()
    plain = _solve_scene(*args)
    traced, _ = _profiled(lambda: _solve_scene(*args))
    assert np.array_equal(plain, traced)
    plain_state, plain_hist = _dip_solver().run(2)
    (traced_state, traced_hist), _ = _profiled(lambda: _dip_solver().run(2))
    for name in ("X", "lambda1", "lambda2"):
        assert torch.equal(getattr(plain_state, name), getattr(traced_state, name)), name
    for k in ("mpsnr", "ssim", "x_dist", "dip_iters"):
        assert plain_hist[k] == traced_hist[k], k
    assert np.array_equal(plain_hist["best_X"], traced_hist["best_X"])
