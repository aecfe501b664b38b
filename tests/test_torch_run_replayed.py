"""Every entry point of the port replays the DIP fit, as the JAX package's
jitted step runs it as one device program: ``Solver.run`` (and so
``inpaint``), the lockstep engines' ``run``, ``solve_tiled(scan=False)`` and
the sharded engine's fit on one rank.  On the CPU the chunked fit runs
eagerly, so the tests walk the code the card runs and check what the card
must keep:

  * each fit reads its stop flag once per ``FIT_CHUNK`` iterations
    (``["tolist"] * ceil(n_iters / 8)``), where the host-stepped fit reads it
    after every iteration;
  * the iterations replayed after the stop or the cap change nothing: X, the
    duals, ``dip_iters`` and the generator's state after each step equal a
    run whose fits are stepped from the host (``OuterStages.fit_chunk``
    None), bit for bit, over 3 outer steps from one seed, for `dip`,
    `dip_1lip` (whose power-iteration buffers advance after the stop; also
    from a ``dip_init`` that loads them) and `dip_fast` (bf16, the
    incremental early stop, the window-mean return);
  * one capture serves every lane and batch (one ``DipFit``), a fit from a
    custom ``dip_fit_factory`` is called without a chunk, and a net whose
    module declares ``capturable = False`` (channel TP over ``model``) is
    stepped from the host, one read per iteration.

Small problems: a 12x12x16 cube (36x36x8 for the Lipschitz U-Net), blocks
of 6, a random 36x48 dictionary, nets of a few channels; the sharded cases on 16x16x16, blocks of 8, over
gloo in two ranks.
"""

import dataclasses
import gc
import math
import weakref

import numpy as np
import pytest
import torch
from torch import nn
from torch.overrides import TorchFunctionMode

from lrs_pnp_dip_tpu_torch import inpaint
from lrs_pnp_dip_tpu_torch.data import random_dictionary, synthetic_sample
from lrs_pnp_dip_tpu_torch.models import LipschitzUNet, Skip
from lrs_pnp_dip_tpu_torch.parallel.launch import spawn
from lrs_pnp_dip_tpu_torch.parallel.workers import run_cases
from lrs_pnp_dip_tpu_torch.solvers import (
    FIT_CHUNK, BatchedSolver, DipFit, OuterStages, SeedEnsembleSolver, Solver, make_consts, solve_tiled,
)
from lrs_pnp_dip_tpu_torch.solvers import admm, init_state
from lrs_pnp_dip_tpu_torch.solvers.tiled import _tiled_engine
from lrs_pnp_dip_tpu_torch.utils import config as tconfig

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

NET = dict(num_output_channels=16, channels_down=(8, 8), channels_up=(8, 8), channels_skip=(4, 4),
           pad="reflection")
DIP = dict(num_iter=20, buffer_size=3, patience=2, learning_rate=0.01)
HOST_READS = {"__float__", "__int__", "__bool__", "__index__", "item", "tolist", "numpy", "cpu"}


class CountHostReads(TorchFunctionMode):
    """Counts the calls that bring a tensor's value to the host."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in HOST_READS:
            self.reads.append(func.__name__)
        return func(*args, **(kwargs or {}))


def _dictionary():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((36, 48)).astype(np.float32)
    return D / np.linalg.norm(D, axis=0, keepdims=True)


def _config(variant):
    base = tconfig.PRESETS[variant.removesuffix("_init")]()
    return dataclasses.replace(
        base, block_size=6, stride=6, net_width=8,
        sparse=dataclasses.replace(base.sparse, n_iter=4), dip=dataclasses.replace(base.dip, **DIP),
    )


def _net(variant):
    if variant.startswith("dip_1lip"):
        return LipschitzUNet(8, num_output_channels=8, width=8)
    return Skip(num_input_channels=16, **NET)


def _sample(variant):
    """12x12x16; the Lipschitz U-Net resizes off the 36x36 geometry."""
    if variant.startswith("dip_1lip"):
        return synthetic_sample(36, 36, 8, missing=0.1, seed=3)
    return synthetic_sample(12, 12, 16, missing=0.1, seed=3)


def _count_fits(stages):
    """Wrap ``stages``' fit: each call's host reads and iteration count."""
    fit, log = stages.dip_fit, []

    def counted(*args, **kw):
        with CountHostReads() as mode:
            res = fit(*args, **kw)
        log.append((mode.reads, res.n_iters))
        return res

    stages.dip_fit = counted
    return log


def _assert_reads(log, per_iteration):
    assert log
    for reads, n in log:
        assert reads == ["tolist"] * (n if per_iteration else math.ceil(n / FIT_CHUNK))


def _dip_init(variant):
    """`dip_1lip_init`: each step's fit starts from a state dict of the net,
    its power-iteration buffers ``u`` included."""
    if variant != "dip_1lip_init":
        return None
    inits = []
    for seed in range(3):
        net = _net(variant)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        inits.append({k: v.clone() for k, v in net.state_dict().items()})
    assert any(k.endswith(".u") for k in inits[0])
    return lambda itr: inits[itr]


@pytest.mark.parametrize("variant", ["dip", "dip_1lip", "dip_1lip_init", "dip_fast"])
def test_solver_run_replays_the_fit(variant):
    """``Solver.run``, 3 outer steps from one seed, against the same run with
    host-stepped fits: each fit reads its flag once per chunk, and X, the
    duals, the history and the generator after every step are equal bits."""
    cfg = _config(variant)
    sample = _sample(variant)
    runs = {}
    for mode in ("replayed", "host"):
        solver = Solver(sample, _dictionary(), cfg, net=_net(variant), device="cpu", dip_init=_dip_init(variant))
        assert solver.stages.fit_chunk == FIT_CHUNK and isinstance(solver.stages.dip_fit, DipFit)
        fit = solver.stages.dip_fit
        if mode == "host":
            solver.stages.fit_chunk = None
        log = _count_fits(solver.stages)
        gens = []
        state, hist = solver.run(3, callback=lambda i, st, aux: gens.append(st.generator.get_state()))
        _assert_reads(log, per_iteration=mode == "host")
        assert [n for _, n in log] == hist["dip_iters"]
        assert fit.flag_reads == len(log[-1][0])
        runs[mode] = state, hist, gens
    (got, got_hist, got_gens), (ref, ref_hist, ref_gens) = runs["replayed"], runs["host"]
    for name in ("X", "lambda1", "lambda2"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for k in ("mpsnr", "ssim", "x_dist", "l1_dist", "l2_dist", "dip_iters"):
        assert got_hist[k] == ref_hist[k], k
    assert all(torch.equal(a, b) for a, b in zip(got_gens, ref_gens)) and len(got_gens) == 3
    # the iterations replayed past a stop or the cap were masked, not absent
    assert any(n % FIT_CHUNK for n in got_hist["dip_iters"])


def test_inpaint_replays_the_fit(monkeypatch):
    """``inpaint(variant="dip")`` (skip-128 on a 12x12x16 cube) reads each
    fit's flag once per chunk and gives the cube of the same solve with
    host-stepped fits."""
    made = []

    def factory(net, dip_cfg):
        made.append(DipFit(net, dip_cfg))
        return made[-1]

    monkeypatch.setattr(admm, "make_dip_fit", factory)
    sample = synthetic_sample(12, 12, 16, missing=0.1, seed=3)
    kw = dict(block_size=6, stride=6, sparse=tconfig.SparseProxConfig(n_iter=4), dip=tconfig.DipConfig(**DIP))
    cube, hist = inpaint(sample.noisy, sample.mask, variant="dip", dictionary=_dictionary(), n_iters=2,
                         device="cpu", **kw)
    assert made[0].flag_reads == math.ceil(hist["dip_iters"][-1] / FIT_CHUNK)
    solver = Solver(sample, _dictionary(), tconfig.dip_preset(**kw), device="cpu")
    solver.stages.fit_chunk = None
    state, ref_hist = solver.run(2)
    assert made[1].flag_reads == ref_hist["dip_iters"][-1]
    assert hist["dip_iters"] == ref_hist["dip_iters"]
    np.testing.assert_array_equal(cube, solver.result_cube(state))


@pytest.mark.parametrize("engine", ["batched", "ensemble"])
def test_lockstep_engines_replay_the_fit(engine):
    """``BatchedSolver.run`` and ``SeedEnsembleSolver.run``, 2 lanes over 3
    steps: one fit serves both lanes, each lane's fit reads once per chunk,
    and the histories and states equal the host-stepped run's bits."""
    cfg = _config("dip")
    D = _dictionary()
    runs = {}
    for mode in ("replayed", "host"):
        if engine == "batched":
            samples = [synthetic_sample(12, 12, 16, missing=0.1, seed=s) for s in (3, 4)]
            eng = BatchedSolver(samples, D, cfg, net=_net("dip"), device="cpu")
        else:
            eng = SeedEnsembleSolver(synthetic_sample(12, 12, 16, missing=0.1, seed=3), D, cfg, seeds=[3, 11],
                                     net=_net("dip"), device="cpu")
        if mode == "host":
            eng.stages.fit_chunk = None
        fit = eng.stages.dip_fit
        log = _count_fits(eng.stages)
        state, hist = eng.run(3)
        _assert_reads(log, per_iteration=mode == "host")
        assert len(log) == 6 and [n for _, n in log] == hist["dip_iters"].ravel().tolist()
        assert (fit._graph is None) == (mode == "host")  # one captured iteration for both lanes
        runs[mode] = state, hist
    (got, got_hist), (ref, ref_hist) = runs["replayed"], runs["host"]
    assert torch.equal(got.X, ref.X) and torch.equal(got.lambda2, ref.lambda2)
    assert set(got_hist) == set(ref_hist)
    for k in got_hist:
        np.testing.assert_array_equal(got_hist[k], ref_hist[k])


def test_solve_tiled_host_loop_replays_the_fit():
    """``solve_tiled(scan=False)``: a 24x24 scene in 4 tiles of 12x12,
    batches of 3 and 1, 2 outer steps; one fit for every batch and lane,
    each reading once per chunk, the scene equal to the host-stepped one."""
    scene = synthetic_sample(24, 24, 16, seed=2)
    cfg = _config("dip")
    net = _net("dip")
    engine = _tiled_engine(cfg, (12, 12, 16), net, torch.device("cpu"))
    fit = engine.stages.dip_fit
    out = {}
    for mode in ("replayed", "host"):
        engine.stages.fit_chunk = None if mode == "host" else FIT_CHUNK
        log = _count_fits(engine.stages)
        try:
            out[mode] = solve_tiled(scene.noisy, scene.mask, _dictionary(), cfg, tile_shape=(12, 12),
                                    tile_batch=3, n_iters=2, net=net, scan=False, device="cpu")
        finally:  # the engine is kept across calls
            engine.stages.dip_fit, engine.stages.fit_chunk = fit, FIT_CHUNK
        _assert_reads(log, per_iteration=mode == "host")
        assert len(log) == 8
    assert out["replayed"].shape == (24, 24, 16) and np.isfinite(out["replayed"]).all()
    np.testing.assert_array_equal(out["replayed"], out["host"])


# -- the sharded engine: the fit on the root rank, and channel TP ------------

SHARD_NET = ("Skip", dict(num_input_channels=16, **NET))


def _shard_cfg():
    return tconfig.SolverConfig(variant="dip", outer_iters=2, block_size=8, stride=8,
                                sparse=tconfig.SparseProxConfig(n_iter=5), dip=tconfig.DipConfig(**DIP))


def _shard_samples():
    return [synthetic_sample(16, 16, 16, missing=0.1, seed=20 + i) for i in range(2)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of two ranks: the `dip` solve on {patch: 2} (2 steps), the
    two lanes on {data: 2} (2 steps) and one step of channel TP on
    {model: 2}."""
    D = random_dictionary(64, 32, seed=4)
    s = _shard_samples()
    case = lambda axes, samples, n: ("solver_case", dict(  # noqa: E731
        axis_sizes=axes, samples=samples, dictionary=D, config=_shard_cfg(), n_steps=n, net_spec=SHARD_NET))
    store = tmp_path_factory.mktemp("ranks")
    return spawn(run_cases, 2, args=("cpu", [case({"patch": 2}, s[0], 2), case({"data": 2}, s, 2),
                                             case({"model": 2}, s[0], 1)]),
                 init_method=f"file://{store / 'two'}")


def _host_stepped(engine):
    engine.stages.fit_chunk = None
    return engine


def test_sharded_fit_on_the_root_replays(ranks):
    """{patch: 2}: the root rank replays the fit (one read per chunk), the
    other reads nothing, and X equals the one-process ``Solver.run`` with
    host-stepped fits bit for bit."""
    res = [r[0] for r in ranks]
    ref = _host_stepped(Solver(_shard_samples()[0], random_dictionary(64, 32, seed=4), _shard_cfg(),
                               net=Skip(num_input_channels=16, **NET), device="cpu"))
    state, hist = ref.run(2)
    for step, n in zip(res[0]["steps"], hist["dip_iters"]):
        assert step["dip_iters"] == n and step["fit_reads"] == math.ceil(n / FIT_CHUNK)
    assert all(step["fit_reads"] == 0 for step in res[1]["steps"])
    for r in res:
        np.testing.assert_array_equal(r["X"], state.X.numpy())


def test_sharded_data_lanes_replay(ranks):
    """{data: 2}: each rank replays its lane's fit and both lanes equal the
    one-process ``BatchedSolver`` with host-stepped fits bit for bit."""
    ref = _host_stepped(BatchedSolver(_shard_samples(), random_dictionary(64, 32, seed=4), _shard_cfg(),
                                      net=Skip(num_input_channels=16, **NET), device="cpu"))
    state, hist = ref.run(2)
    for lane, r in enumerate(ranks):
        for step, n in zip(r[1]["steps"], hist["dip_iters"][:, lane]):
            assert step["dip_iters"] == [n] and step["fit_reads"] == math.ceil(n / FIT_CHUNK)
        np.testing.assert_array_equal(r[1]["X"], state.X.numpy())


def test_channel_tp_fit_stays_host_stepped(ranks):
    """{model: 2}: the TP net's module declares it cannot be captured, so
    each rank steps the fit from the host, one read per iteration."""
    for r in ranks:
        step = r[2]["steps"][0]
        assert 0 < step["dip_iters"] <= DIP["num_iter"] and step["fit_reads"] == step["dip_iters"]
        assert np.isfinite(r[2]["X"]).all()


# -- what decides the chunk ---------------------------------------------------


def test_a_custom_fit_factory_is_called_without_a_chunk():
    cfg = _config("dip")
    sample = synthetic_sample(12, 12, 16, missing=0.1, seed=3)
    calls = []

    def fit(dip_input, target, mask, **kw):
        calls.append(kw)
        return DipFit(_net("dip"), cfg.dip)(dip_input, target, mask, **kw)

    stages = OuterStages(cfg, sample.shape, net=_net("dip"), device="cpu",
                         dip_fit_factory=lambda net, dip_cfg: fit)
    assert stages.fit_chunk is None
    U, n, _ = stages.low_rank(init_state(sample, 0, device="cpu"), make_consts(sample, _dictionary(), cfg, "cpu"))
    assert calls and "chunk" not in calls[0] and 0 < n <= DIP["num_iter"] and U.shape == (144, 16)


class _Uncapturable(nn.Module):
    """A net whose module says a graph cannot hold it."""

    capturable = False

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(()))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x):
        return torch.sigmoid(x * self.scale)


def test_a_net_that_cannot_be_captured_is_stepped_from_the_host():
    """The fit reads ``capturable`` before it starts: asked for chunks, it
    steps from the host (one read per iteration) and gives the same bits."""
    rng = np.random.default_rng(1)
    x, t = (torch.from_numpy(rng.random((1, 6, 6, 4), dtype=np.float32)) for _ in range(2))
    m = torch.ones((1, 6, 6, 1))
    fit = DipFit(_Uncapturable(), tconfig.DipConfig(num_iter=11, buffer_size=3, patience=50, learning_rate=0.01))
    host = fit(x, t, m)
    with CountHostReads() as mode:
        got = fit(x, t, m, chunk=FIT_CHUNK)
    assert mode.reads == ["tolist"] * 11 and fit.flag_reads == 11 and fit._graph is None
    assert got.n_iters == host.n_iters == 11 and torch.equal(got.out, host.out)


def test_a_dropped_solver_frees_its_fit_at_once():
    """The fit's captured iteration holds the fit weakly: dropping the
    solver frees the fit (and on the card its graph's memory pool) with the
    garbage collector off."""
    cfg = _config("dip")
    solver = Solver(synthetic_sample(12, 12, 16, missing=0.1, seed=3), _dictionary(), cfg, net=_net("dip"),
                    device="cpu")
    solver.run(1)
    assert solver.stages.dip_fit._graph is not None
    gone = weakref.ref(solver.stages.dip_fit)
    gc.disable()
    try:
        del solver
        assert gone() is None
    finally:
        gc.enable()
