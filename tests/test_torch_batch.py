"""The port's lockstep engines against its single solver and the JAX engines.

On `lrs_pnp` lanes everything is deterministic: every lane must equal a
single ``Solver`` run of the same sample (atol 1e-5 of the scale: the
concatenated sparse prox and the batched ``eigh`` group their sums
differently) and the JAX engine (rtol / atol 1e-4 of the scale, the
tolerance of the single-solve test).  On `dip` lanes the fit is short and
its init fixed through ``dip_init`` for the value comparison; with the
generators' own draws lane i reproduces a single solve seeded ``seed + i``."""

import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.data.masks import synthetic_sample as j_synthetic_sample
from lrs_pnp_dip_tpu.solvers import batch as jbatch
from lrs_pnp_dip_tpu.utils import config as jconfig
from lrs_pnp_dip_tpu_torch.data import synthetic_sample
from lrs_pnp_dip_tpu_torch.models import Skip
from lrs_pnp_dip_tpu_torch.ops import ista as tista
from lrs_pnp_dip_tpu_torch.solvers import (
    BatchedSolver, SeedEnsembleSolver, Solver, stack_consts, stack_states,
)
from lrs_pnp_dip_tpu_torch.utils import config as tconfig

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

NET = dict(num_output_channels=16, channels_down=(8, 8), channels_up=(8, 8),
           channels_skip=(4, 4), pad="reflection")
LRS = dict(variant="lrs_pnp", outer_iters=2, block_size=6, stride=6, dip=None, mu1=0.15, mu2=0.9)
SPARSE = dict(n_iter=10, alpha_mode="specnorm", h_scale=0.1)


def _dictionary():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((36, 48)).astype(np.float32)
    return D / np.linalg.norm(D, axis=0, keepdims=True)


def _close(ours, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=tol, atol=tol * np.abs(ref).max())


def test_batched_lrs_pnp_lanes_equal_single_solves_and_jax():
    D = _dictionary()
    t_cfg = tconfig.SolverConfig(sparse=tconfig.SparseProxConfig(**SPARSE), **LRS)
    j_cfg = jconfig.SolverConfig(sparse=jconfig.SparseProxConfig(**SPARSE), **LRS)
    seeds = (3, 4, 5)
    samples = [synthetic_sample(12, 12, 16, missing=0.1, seed=k) for k in seeds]
    engine = BatchedSolver(samples, D, t_cfg, device="cpu")
    state, hist = engine.run()
    assert state.X.shape == (3, 144, 16) and len(state.generator) == 3 and state.itr == 2
    assert engine.consts.D.shape == (36, 48)  # the dictionary is kept once
    assert engine.consts.mask_blocks.shape[0] == 3
    assert set(hist) == {"mpsnr", "ssim", "dip_iters"}
    assert all(hist[k].shape == (2, 3) for k in hist) and not hist["dip_iters"].any()
    j_state, j_hist = jbatch.BatchedSolver(
        [j_synthetic_sample(12, 12, 16, missing=0.1, seed=k) for k in seeds], D, j_cfg
    ).run()
    _close(state.X, j_state.X, 1e-4)
    np.testing.assert_allclose(hist["mpsnr"], j_hist["mpsnr"], atol=1e-3)
    np.testing.assert_allclose(hist["ssim"], j_hist["ssim"], atol=1e-4)
    cubes = engine.result_cubes(state)
    assert cubes.shape == (3, 12, 12, 16)
    for i, s in enumerate(samples):
        solver = Solver(s, D, t_cfg, device="cpu")
        one, one_hist = solver.run()
        _close(state.X[i], one.X, 1e-5)
        _close(state.lambda1[i], one.lambda1, 1e-5)
        _close(cubes[i], solver.result_cube(one), 1e-5)
        np.testing.assert_allclose(hist["mpsnr"][:, i], one_hist["mpsnr"], atol=1e-4)
    with pytest.raises(ValueError, match="share a shape"):
        BatchedSolver([samples[0], synthetic_sample(18, 12, 16, seed=0)], D, t_cfg, device="cpu")


def test_seed_ensemble_lrs_pnp_lanes_equal_the_single_solve_and_jax():
    D = _dictionary()
    t_cfg = tconfig.SolverConfig(sparse=tconfig.SparseProxConfig(**SPARSE), **LRS)
    j_cfg = jconfig.SolverConfig(sparse=jconfig.SparseProxConfig(**SPARSE), **LRS)
    s = synthetic_sample(12, 12, 16, missing=0.1, seed=6)
    ens = SeedEnsembleSolver(s, D, t_cfg, seeds=[0, 7, 9], device="cpu")
    # the lanes share one copy of the constants
    assert ens.consts.Y.shape == (3, 144, 16) and ens.consts.Y.stride(0) == 0
    state, hist = ens.run()
    assert set(hist) == {"mpsnr", "ssim", "dip_iters", "ens_mpsnr", "ens_ssim"}
    assert hist["mpsnr"].shape == hist["dip_iters"].shape == (2, 3)
    assert hist["ens_mpsnr"].shape == hist["ens_ssim"].shape == (2,)
    one, one_hist = Solver(s, D, t_cfg, device="cpu").run()
    for i in range(3):
        _close(state.X[i], one.X, 1e-5)
    # the mean of equal lanes is the lane
    np.testing.assert_allclose(hist["ens_mpsnr"], one_hist["mpsnr"], atol=1e-4)
    j_state, j_hist = jbatch.SeedEnsembleSolver(
        j_synthetic_sample(12, 12, 16, missing=0.1, seed=6), D, j_cfg, seeds=[0, 7, 9]
    ).run()
    _close(state.X, j_state.X, 1e-4)
    for k in ("mpsnr", "ens_mpsnr"):
        np.testing.assert_allclose(hist[k], j_hist[k], atol=1e-3)
    np.testing.assert_allclose(hist["ens_ssim"], j_hist["ens_ssim"], atol=1e-4)
    chunked_state, chunked = ens.run_chunked(2, chunk=1)
    np.testing.assert_array_equal(chunked["mpsnr"], hist["mpsnr"])
    with pytest.raises(ValueError, match="chunk"):
        ens.run_chunked(2, chunk=0)
    with pytest.raises(ValueError, match="at least one seed"):
        SeedEnsembleSolver(s, D, t_cfg, seeds=[], device="cpu")


def _dip_cfg(**dip):
    return tconfig.SolverConfig(
        variant="dip", outer_iters=2, block_size=6, stride=6,
        sparse=tconfig.SparseProxConfig(n_iter=10),
        dip=tconfig.DipConfig(**{**dict(num_iter=6, buffer_size=3, patience=2, learning_rate=0.01), **dip}),
    )


def _fixed_init():
    net = Skip(num_input_channels=16, **NET)
    net.reset_parameters(torch.Generator().manual_seed(1))
    init = {k: v.clone() for k, v in net.state_dict().items()}
    return lambda itr: init


@pytest.mark.parametrize("engine", ["batched", "ensemble"])
def test_dip_lanes_equal_single_solves(engine):
    """`dip` lanes with a ``dip_init``-fixed init: lane i equals a single
    ``Solver`` (seed ``seed + i``) of the same sample, within 1e-4 of the
    scale (the fit is short, so Adam does not amplify the regrouped sums of
    the concatenated sparse prox)."""
    D, cfg, init = _dictionary(), _dip_cfg(), _fixed_init()
    samples = [synthetic_sample(12, 12, 16, missing=0.1, seed=k) for k in (3, 4)]
    if engine == "batched":
        eng = BatchedSolver(samples, D, cfg, net=Skip(num_input_channels=16, **NET),
                            device="cpu", dip_init=init)
        lanes = [(s, cfg.seed + i) for i, s in enumerate(samples)]
    else:
        eng = SeedEnsembleSolver(samples[0], D, cfg, seeds=[5, 6], net=Skip(num_input_channels=16, **NET),
                                 device="cpu", dip_init=init)
        lanes = [(samples[0], 5), (samples[0], 6)]
    state, hist = eng.run()
    assert hist["dip_iters"].shape == (2, 2) and (hist["dip_iters"] > 0).all()
    for i, (s, seed) in enumerate(lanes):
        solver = Solver(s, D, cfg, net=Skip(num_input_channels=16, **NET), device="cpu", dip_init=init)
        one, one_hist = solver.run(state=solver.init_state(seed))
        _close(state.X[i], one.X, 1e-4)
        np.testing.assert_array_equal(hist["dip_iters"][:, i], one_hist["dip_iters"])
        np.testing.assert_allclose(hist["mpsnr"][:, i], one_hist["mpsnr"], atol=1e-3)


def test_dip_lanes_draw_from_their_own_generators():
    """Without ``dip_init`` lane i draws its nets from a generator seeded
    ``seed + i``, as a single solve with that seed does: 3 DIP iterations at
    lr 1e-3, within 1e-3 of the scale.  Two seeds give two different lanes."""
    D, cfg = _dictionary(), _dip_cfg(num_iter=3, learning_rate=1e-3)
    s = synthetic_sample(12, 12, 16, missing=0.1, seed=3)
    ens = SeedEnsembleSolver(s, D, cfg, seeds=[11, 12], net=Skip(num_input_channels=16, **NET), device="cpu")
    state, hist = ens.run(2)
    assert not torch.allclose(state.X[0], state.X[1], atol=1e-4)
    for i, seed in enumerate((11, 12)):
        solver = Solver(s, D, cfg, net=Skip(num_input_channels=16, **NET), device="cpu")
        one, _ = solver.run(2, state=solver.init_state(seed))
        _close(state.X[i], one.X, 1e-3)
    batched = BatchedSolver([s, s], D, cfg, net=Skip(num_input_channels=16, **NET), device="cpu")
    b_state, _ = batched.run(2, state=batched.init_state(seed=11))
    _close(b_state.X, state.X, 1e-3)


def test_one_sparse_prox_call_per_outer_step_whatever_the_lane_count(monkeypatch):
    """The lanes' blocks go through ONE call of the ISTA loop, concatenated
    to (N * nB, P) against the one dictionary: on the card that is one
    launch of kernel B1 per outer step."""
    D = _dictionary()
    cfg = tconfig.SolverConfig(sparse=tconfig.SparseProxConfig(**SPARSE), **LRS)
    samples = [synthetic_sample(12, 12, 16, missing=0.1, seed=k) for k in range(4)]
    shapes = []
    plain = tista.pnp_ista_blocks

    def counting(blocks, mask_blocks, D_, cfg_, alpha=None):
        shapes.append((tuple(blocks.shape), tuple(mask_blocks.shape), tuple(D_.shape), tuple(alpha.shape)))
        return plain(blocks, mask_blocks, D_, cfg_, alpha=alpha)

    monkeypatch.setattr(tista, "pnp_ista_blocks", counting)
    BatchedSolver(samples, D, cfg, device="cpu").run(2)
    n_blocks = 72  # 24 pixel starts x 3 band starts (0, 6, 10)
    assert shapes == [((4 * n_blocks, 36), (4 * n_blocks, 36), (36, 48), (4 * n_blocks,))] * 2


def test_stack_helpers_and_spread():
    D = _dictionary()
    cfg = tconfig.SolverConfig(sparse=tconfig.SparseProxConfig(**SPARSE), **LRS)
    solvers = [Solver(synthetic_sample(12, 12, 16, seed=k), D, cfg, device="cpu") for k in (0, 1)]
    consts = stack_consts([s.consts for s in solvers])
    assert consts.Y.shape == (2, 144, 16) and consts.alpha.shape == (2, 72)
    assert consts.D is solvers[0].consts.D
    state = stack_states([s.init_state(k) for k, s in enumerate(solvers)])
    assert state.X.shape == (2, 144, 16) and state.itr == 0
    assert torch.equal(state.X[1], solvers[1].consts.Y)
    ens = SeedEnsembleSolver(solvers[0].sample, D, cfg, seeds=[0, 1, 2], device="cpu")
    hist = {"mpsnr": np.array([[30.0, 31.0, np.nan], [32.0, 30.5, 29.0]])}
    got = ens.spread(hist)
    assert got["per_seed_best"] == [32.0, 31.0, 29.0]
    assert got["max"] == 32.0 and got["min"] == 29.0
    np.testing.assert_allclose(got["mean"], np.mean([32.0, 31.0, 29.0]))
    np.testing.assert_allclose(got["std"], np.std([32.0, 31.0, 29.0]))
