"""The port's ShardedSolver against the JAX ShardedSolver and Solver, and
against the port's own unsharded engines.

Ranks are spawned through the port's launcher on the CPU over gloo (a file
store under ``tmp_path``); the checks that share a world size share a spawn.
Problems follow ``tests/test_parallel.py``: a 16x16x16 synthetic cube,
block 8, a random 64x32 dictionary, 5 ISTA iterations.

Tolerances: `lrs_pnp` X within 5e-4 and MPSNR within 1e-2 of the JAX
solves (``tests/test_parallel.py:58``, ``:257``); the `dip` lanes of
``{data: 2, patch: 2}``, with the flax init transplanted through
``params_from_flax``, equal to the port's ``BatchedSolver`` bit for bit
(each rank runs the same loop on its rows, and the fit runs on one rank per
lane); a one-rank mesh equal to ``Solver`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.data import random_dictionary as j_random_dictionary
from lrs_pnp_dip_tpu.data.masks import synthetic_sample as j_synthetic_sample
from lrs_pnp_dip_tpu.models import Skip as JSkip
from lrs_pnp_dip_tpu.ops.ista import SparseProxConfig as JSparse
from lrs_pnp_dip_tpu.parallel import ShardedSolver as JShardedSolver, make_mesh as j_make_mesh
from lrs_pnp_dip_tpu.solvers import Solver as JSolver
from lrs_pnp_dip_tpu.utils.config import SolverConfig as JSolverConfig
from lrs_pnp_dip_tpu_torch.data import random_dictionary, synthetic_sample
from lrs_pnp_dip_tpu_torch.models import Skip, params_from_flax
from lrs_pnp_dip_tpu_torch.parallel import make_mesh
from lrs_pnp_dip_tpu_torch.parallel.launch import spawn
from lrs_pnp_dip_tpu_torch.parallel.workers import run_cases
from lrs_pnp_dip_tpu_torch.solvers import BatchedSolver, Solver
from lrs_pnp_dip_tpu_torch.utils.config import DipConfig, SolverConfig, SparseProxConfig

torch.set_num_threads(1)

NET = dict(num_output_channels=16, channels_down=(8, 8), channels_up=(8, 8),
           channels_skip=(4, 4), pad="reflection")
LRS = dict(variant="lrs_pnp", outer_iters=2, block_size=8, stride=8, dip=None)
DIP = dict(variant="dip", outer_iters=1, block_size=8, stride=8)
DIP_FIT = dict(num_iter=15, learning_rate=0.05, buffer_size=5, patience=30)
MESHES = ({"patch": 2}, {"patch": 2, "band": 2})


def _lrs_cfg():
    return SolverConfig(sparse=SparseProxConfig(n_iter=5), **LRS)


def _dip_cfg():
    return SolverConfig(sparse=SparseProxConfig(n_iter=5), dip=DipConfig(**DIP_FIT), **DIP)


def _lrs_problem():
    return synthetic_sample(16, 16, 16, missing=0.1, seed=7), random_dictionary(64, 32, seed=2)


def _dip_samples():
    return [synthetic_sample(16, 16, 16, missing=0.1, seed=20 + i) for i in range(2)]


def _dip_inits():
    """The flax net's init for the one outer step, as a torch state dict."""
    params = JSkip(**NET).init(jax.random.PRNGKey(4), jnp.zeros((1, 16, 16, 16)))["params"]
    return [params_from_flax(jax.tree.map(np.asarray, params), Skip(num_input_channels=16, **NET))]


def _solver_case(axis_sizes, samples, D, cfg, n_steps, **kw):
    return ("solver_case", dict(
        axis_sizes=axis_sizes, samples=samples, dictionary=D, config=cfg, n_steps=n_steps, **kw
    ))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn of this file: {patch: 2}; {patch: 2, band: 2} and
    {data: 2, patch: 2}; one rank."""
    s, D = _lrs_problem()
    dip_net = ("Skip", dict(num_input_channels=16, **NET))
    store = tmp_path_factory.mktemp("ranks")
    out = {}
    out[2] = spawn(run_cases, 2, args=("cpu", [_solver_case(MESHES[0], s, D, _lrs_cfg(), 2)]),
                   init_method=f"file://{store / 'two'}")
    out[4] = spawn(run_cases, 4, args=("cpu", [
        _solver_case(MESHES[1], s, D, _lrs_cfg(), 2),
        _solver_case({"data": 2, "patch": 2}, _dip_samples(), random_dictionary(64, 32, seed=4),
                     _dip_cfg(), 1, net_spec=dip_net, dip_inits=_dip_inits()),
    ]), init_method=f"file://{store / 'four'}")
    out[1] = spawn(run_cases, 1, args=("cpu", [
        _solver_case({"patch": 1}, s, D, _lrs_cfg(), 2),
        _solver_case({"patch": 1}, _dip_samples()[0], random_dictionary(64, 32, seed=4),
                     _dip_cfg(), 1, net_spec=dip_net, dip_inits=_dip_inits()),
    ]), init_method=f"file://{store / 'one'}")
    return out


@pytest.mark.parametrize("axis_sizes", MESHES, ids=["patch2", "patch2_band2"])
def test_sharded_lrs_pnp_matches_jax(runs, axis_sizes):
    n = int(np.prod(list(axis_sizes.values())))
    res = runs[n][0][0]
    for r in runs[n][1:]:
        np.testing.assert_array_equal(r[0]["X"], res["X"])
    s = j_synthetic_sample(height=16, width=16, bands=16, missing=0.1, seed=7)
    D = j_random_dictionary(64, 32, seed=2)
    cfg = JSolverConfig(sparse=JSparse(n_iter=5), **LRS)
    st1, h1 = JSolver(s, D, cfg).run()
    st2, h2 = JShardedSolver(s, D, cfg, j_make_mesh(axis_sizes, devices=jax.devices()[:n])).run()
    mpsnr = [float(step["mpsnr"]) for step in res["steps"]]
    for X, hist in ((st1.X, h1["mpsnr"]), (st2.X, np.asarray(h2["mpsnr"]).ravel())):
        np.testing.assert_allclose(res["X"], np.asarray(X), atol=5e-4)
        np.testing.assert_allclose(mpsnr, hist, atol=1e-2)
    # the 1-D path runs the Gram all_reduce SVT; the 2-D path moves more
    assert all(step["launches"] == 0 for step in res["steps"])
    assert all(step["bytes"] > 0 for step in res["steps"])


def test_sharded_batched_dip_lanes_equal_batched_solver(runs):
    """{data: 2, patch: 2}: each data group solves its lane, the blocks
    split over patch and the fit on the group's first rank; both lanes
    equal the port's BatchedSolver from the same transplanted init."""
    res = runs[4][0][1]
    assert res["X"].shape == (2, 256, 16) and np.isfinite(res["X"]).all()
    inits = _dip_inits()
    ref = BatchedSolver(_dip_samples(), random_dictionary(64, 32, seed=4), _dip_cfg(),
                        net=Skip(num_input_channels=16, **NET), device="cpu",
                        dip_init=lambda itr: inits[itr])
    state, hist = ref.run(1)
    np.testing.assert_array_equal(res["X"], state.X.numpy())
    np.testing.assert_array_equal(res["steps"][0]["mpsnr"], hist["mpsnr"][0])
    # rank 0 holds lane 0, rank 2 lane 1 (data is the slow axis)
    assert runs[4][0][1]["steps"][0]["dip_iters"] == [hist["dip_iters"][0, 0]]
    assert runs[4][2][1]["steps"][0]["dip_iters"] == [hist["dip_iters"][0, 1]]


@pytest.mark.parametrize("variant", ["lrs_pnp", "dip"])
def test_one_rank_mesh_equals_solver_bit_for_bit(runs, variant):
    res = runs[1][0][0 if variant == "lrs_pnp" else 1]
    if variant == "lrs_pnp":
        (s, D), cfg, kw = _lrs_problem(), _lrs_cfg(), {}
    else:
        inits = _dip_inits()
        s, D, cfg = _dip_samples()[0], random_dictionary(64, 32, seed=4), _dip_cfg()
        kw = dict(net=Skip(num_input_channels=16, **NET), dip_init=lambda itr: inits[itr])
    solver = Solver(s, D, cfg, device="cpu", **kw)
    state = solver.init_state()
    for step in res["steps"]:
        state, aux = solver.step(state)
        np.testing.assert_array_equal(step["phi_scatter"], aux.phi_scatter.numpy())
        assert float(step["mpsnr"]) == float(aux.mpsnr)
        assert step["bytes"] == 0
    np.testing.assert_array_equal(res["X"], state.X.numpy())


def test_mesh_size_must_equal_world_size():
    with pytest.raises(Exception, match="needs 2 ranks, have 1"):
        spawn(make_mesh, 1, args=({"patch": 2}, "cpu"))
