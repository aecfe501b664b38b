"""Channel tensor parallelism of the port's DIP nets over ``model``, against
the JAX package's layout and the port's unsharded training.

Ranks are spawned through the port's launcher on the CPU over gloo (a file
store under ``tmp_path``).  Tolerances are the JAX package's
(``tests/test_tensor_parallel.py``): gradients of the first step within
5e-4 of their scale / rtol 1e-3, and after three Adam steps the loss within
rtol 1e-3 and the output within atol 2e-3 / rtol 1e-2 (``:57``); the
``{patch: 2, model: 2}`` solver step against the unsharded one with
phi_scatter within 1e-5, X within 5e-2, the DIP loss within rtol 5e-2 and
MPSNR within rtol 1e-3 (``:156``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.models import Skip as JSkip
from lrs_pnp_dip_tpu.parallel import make_mesh as j_make_mesh
from lrs_pnp_dip_tpu.parallel.tensor import (
    channel_sharding_report as j_report,
    channel_sharding_specs as j_specs,
)
from lrs_pnp_dip_tpu_torch.data import random_dictionary, synthetic_sample
from lrs_pnp_dip_tpu_torch.models import Skip
from lrs_pnp_dip_tpu_torch.parallel import channel_sharding_report
from lrs_pnp_dip_tpu_torch.parallel.launch import spawn
from lrs_pnp_dip_tpu_torch.parallel.workers import run_cases
from lrs_pnp_dip_tpu_torch.solvers import Solver
from lrs_pnp_dip_tpu_torch.utils.config import DipConfig, SolverConfig, SparseProxConfig

torch.set_num_threads(1)

NET = dict(num_output_channels=16, channels_down=(8, 8), channels_up=(8, 8),
           channels_skip=(4, 4), pad="reflection")
# net spec, and the side of the problem (the U-Net halves it four times, and
# its spectrally normalised batch norm needs more than one value per channel)
NETS = {
    "skip": (("Skip", dict(num_input_channels=16, **NET)), 16),
    "lipschitz_unet": (("LipschitzUNet", dict(num_input_channels=16, num_output_channels=16, width=8)), 32),
}
DIP_CFG = SolverConfig(
    variant="dip", outer_iters=1, block_size=8, stride=8,
    sparse=SparseProxConfig(n_iter=4, backend="xla"),
    dip=DipConfig(num_iter=4, learning_rate=0.05, buffer_size=3, patience=10),
)


def _problem(side, bands=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, side, side, bands)).astype(np.float32)
    target = rng.standard_normal((1, side, side, bands)).astype(np.float32)
    mask = (rng.random((1, side, side, 1)) > 0.2).astype(np.float32)
    return x, target, mask


def _solver_problem():
    return synthetic_sample(16, 16, 16, missing=0.1, seed=3), random_dictionary(64, 32, seed=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    store = tmp_path_factory.mktemp("ranks")
    tp = []
    for spec, side in NETS.values():
        x, target, mask = _problem(side)
        tp.append(("tp_case", dict(axis_sizes={"model": 2}, net_spec=spec, x=x, target=target,
                                   mask=mask, seed=42, lr=0.1, n_steps=3)))
    sample, D = _solver_problem()
    solver = ("solver_case", dict(axis_sizes={"patch": 2, "model": 2}, samples=sample, dictionary=D,
                                  config=DIP_CFG, n_steps=1, net_spec=NETS["skip"][0]))
    return {
        2: spawn(run_cases, 2, args=("cpu", tp), init_method=f"file://{store / 'two'}"),
        4: spawn(run_cases, 4, args=("cpu", [solver]), init_method=f"file://{store / 'four'}"),
    }


def _oihw(shape):
    """A flax HWIO kernel shape in torch's OIHW order."""
    return (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape


def test_report_and_specs_match_jax(runs):
    params = JSkip(**NET).init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16)))["params"]
    ref = j_report(params, 2)
    ours = channel_sharding_report(Skip(num_input_channels=16, **NET), 2)
    assert ours == runs[2][0][0]["report"]
    for key in ("sharded", "indivisible_convs"):
        assert sorted(s for _, s in ours[key]) == sorted(_oihw(s) for _, s in ref[key])
    assert ours["replicated_other"] == ref["replicated_other"]
    assert len([s for _, s in ours["sharded"] if len(s) == 4]) == 11  # 5 per scale, the head
    # specs: the same tensors split, output channels on dim 0
    jspecs = jax.tree.leaves(j_specs(params, j_make_mesh({"model": 2}, devices=jax.devices()[:2])))
    specs = runs[2][0][0]["specs"]
    assert sum(s.spec != () for s in jspecs) == sum(s != () for s in specs.values()) == len(ours["sharded"])
    assert all(s[0] == "model" for s in specs.values() if s != ())


def test_report_lists_indivisible_kernels():
    report = channel_sharding_report({"w": torch.zeros(6, 5, 3, 3), "b": torch.zeros(7)}, 4)
    assert report["indivisible_convs"] == [("w", (6, 5, 3, 3))]
    assert report["sharded"] == [] and report["replicated_other"] == 1


def test_strict_raises_on_indivisible(runs):
    assert all("indivisible" in r[0]["strict_error"] for r in runs[2])


def test_born_slices_a_whole_state_dict(runs):
    whole = Skip(num_input_channels=16, **NET).state_dict()
    for r in runs[2]:
        born, specs = r[0]["born"], r[0]["specs"]
        assert set(born) == set(whole)
        for name, shape in born.items():
            split = specs[name] != ()
            assert shape == ((whole[name].shape[0] // 2,) + tuple(whole[name].shape[1:]) if split
                             else tuple(whole[name].shape))


def test_wide_net_splits_every_kernel():
    """The w=512 hourglass on an 8-way axis (shapes only): every conv kernel
    splits, as in the JAX package."""
    with torch.device("meta"):
        net = Skip(128, 128, channels_down=(512,) * 5, channels_up=(512,) * 5,
                   channels_skip=(8,) * 5, pad="reflection")
    report = channel_sharding_report(net, 8)
    assert not report["indivisible_convs"]
    assert len([s for _, s in report["sharded"] if len(s) == 4]) >= 20


@pytest.mark.parametrize("net", list(NETS))
def test_tp_dip_step_matches_unsharded(runs, net):
    """The first step's gradients of every rank's slices, then three Adam
    steps (``make_tp_dip_step``) against the unsharded net on the same init."""
    for rank_result in runs[2]:
        res = rank_result[list(NETS).index(net)]
        assert any(split for _, _, split, _ in res["grads"].values())
        for name, (ours, ref, _, _) in res["grads"].items():
            scale = max(float(np.abs(ref).max()), 1e-3)
            np.testing.assert_allclose(ours, ref, atol=5e-4 * scale, rtol=1e-3, err_msg=name)
        np.testing.assert_allclose(res["tp_losses"][-1], res["ref_losses"][-1], rtol=1e-3)
        np.testing.assert_allclose(res["out_tp"], res["out_ref"], atol=2e-3, rtol=1e-2)


def test_sharded_solver_patch_model_matches_solver(runs):
    """TP inside the solver's DIP fit on {patch: 2, model: 2} against the
    port's unsharded step from the same generator."""
    sample, D = _solver_problem()
    solver = Solver(sample, D, DIP_CFG, net=Skip(num_input_channels=16, **NET), device="cpu")
    state, aux = solver.step(solver.init_state())
    for r in runs[4]:
        res = r[0]
        step = res["steps"][0]
        np.testing.assert_allclose(step["phi_scatter"], aux.phi_scatter.numpy(), atol=1e-5)
        np.testing.assert_allclose(res["X"], state.X.numpy(), atol=5e-2)
        np.testing.assert_allclose(float(step["dip_loss"]), float(aux.dip_loss), rtol=5e-2)
        np.testing.assert_allclose(float(step["mpsnr"]), float(aux.mpsnr), rtol=1e-3)
        assert step["dip_iters"] == aux.dip_iters
