"""The port's utilities against the JAX package: checkpoint and resume,
state carried across from a JAX solve, metric logging, the profiler
hooks, the figure writers, and mse / psnr_standard.

Tolerances: a resumed solve equals the uninterrupted one bit for bit (the
CPU step is deterministic, and the restored generator draws the same DIP
init); a JAX mid-solve state continued one step in each package agrees at
the `lrs_pnp` solve's tolerance, 1e-4 of max|X| (tests/test_torch_solver.py);
the metrics within 1e-6 relative (one f32 mean)."""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.data import random_dictionary
from lrs_pnp_dip_tpu.data.masks import synthetic_sample as j_synthetic_sample
from lrs_pnp_dip_tpu.ops import metrics as jmetrics
from lrs_pnp_dip_tpu.solvers import Solver as JSolver
from lrs_pnp_dip_tpu.utils import config as jconfig
from lrs_pnp_dip_tpu.utils.checkpoint import pytree_to_state as j_pytree_to_state
from lrs_pnp_dip_tpu.utils.checkpoint import state_to_pytree
from lrs_pnp_dip_tpu_torch.data import synthetic_sample
from lrs_pnp_dip_tpu_torch.models import Skip
from lrs_pnp_dip_tpu_torch.ops import mse, psnr_standard
from lrs_pnp_dip_tpu_torch.solvers import Solver
from lrs_pnp_dip_tpu_torch.utils import config as tconfig
from lrs_pnp_dip_tpu_torch.utils.checkpoint import (
    SolverCheckpointer, pytree_to_state, state_from_jax_pytree,
)
from lrs_pnp_dip_tpu_torch.utils.checkpoint import state_to_pytree as t_state_to_pytree
from lrs_pnp_dip_tpu_torch.utils.logging import MetricLogger
from lrs_pnp_dip_tpu_torch.utils.profiling import annotate, trace

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

D = random_dictionary(36, 24, seed=1)


def _lrs_pnp(mod):
    return mod.SolverConfig(
        variant="lrs_pnp", outer_iters=2, block_size=6, stride=6,
        sparse=mod.SparseProxConfig(n_iter=4), dip=None,
    )


def _dip():
    return tconfig.SolverConfig(
        variant="dip", mu1=0.1, mu2=0.1, outer_iters=2, block_size=6, stride=6,
        sparse=tconfig.SparseProxConfig(n_iter=4),
        dip=tconfig.DipConfig(num_iter=6, buffer_size=3, patience=2, learning_rate=0.01),
    )


def _sample():
    return synthetic_sample(height=12, width=12, bands=16, missing=0.1, seed=6)


def _assert_same_state(a, b):
    for name in ("X", "lambda1", "lambda2"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.itr == b.itr


@pytest.mark.parametrize("variant", ["lrs_pnp", "dip"])
def test_checkpoint_resume_is_exact(tmp_path, variant):
    """Save after step 1, restore, take step 2: equal bits to the
    uninterrupted step 2.  For `dip` the restored generator draws the next
    DIP init, so the resumed fit starts from the same parameters."""
    if variant == "lrs_pnp":
        solver = Solver(_sample(), D, _lrs_pnp(tconfig), device="cpu")
    else:
        net = Skip(num_input_channels=16, num_output_channels=16, channels_down=(4,), channels_up=(4,),
                   channels_skip=(2,), pad="reflection")
        solver = Solver(_sample(), D, _dip(), net=net, device="cpu")
    st1, _ = solver.step(solver.init_state())
    ck = SolverCheckpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    ck.save(st1.itr, st1)
    st2, _ = solver.step(st1)
    restored = ck.restore(device="cpu")
    _assert_same_state(restored, st1)
    resumed, _ = solver.step(restored)
    _assert_same_state(resumed, st2)
    ck.close()


def test_checkpointer_keeps_the_newest_and_refuses_other_devices(tmp_path):
    solver = Solver(_sample(), D, _lrs_pnp(tconfig), device="cpu")
    ck = SolverCheckpointer(str(tmp_path), max_to_keep=2)
    assert ck.latest_step() is None and ck.restore(device="cpu") is None
    states = [solver.init_state()]
    for _ in range(3):
        states.append(solver.step(states[-1])[0])
        ck.save(states[-1].itr, states[-1])
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    _assert_same_state(ck.restore(2, device="cpu"), states[2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ck.restore()  # the card by default
    record = torch.load(os.path.join(str(tmp_path), "step_3.pt"), weights_only=True)
    record["generator_device"] = "cuda"
    torch.save(record, os.path.join(str(tmp_path), "step_4.pt"))
    with pytest.raises(ValueError, match="cuda generator"):
        ck.restore(4, device="cpu")


def test_state_from_jax_pytree_continues_a_jax_solve():
    """A JAX `lrs_pnp` state after one outer step, carried across as the JAX
    checkpointer writes it, and continued one step in each package."""
    s_t = _sample()
    s_j = j_synthetic_sample(height=12, width=12, bands=16, missing=0.1, seed=6)
    j_solver = JSolver(s_j, D, _lrs_pnp(jconfig))
    j_state, _ = j_solver.step(j_solver.init_state())
    state = state_from_jax_pytree(state_to_pytree(j_state), torch.Generator().manual_seed(0))
    assert state.itr == 1 and state.X.dtype == torch.float32 and state.generator.device.type == "cpu"
    np.testing.assert_array_equal(state.X.numpy(), np.asarray(j_state.X))
    t_next, _ = Solver(s_t, D, _lrs_pnp(tconfig), device="cpu").step(state)
    j_next, _ = j_solver.step(j_state)
    for name in ("X", "lambda1", "lambda2"):
        ref = np.asarray(getattr(j_next, name))
        np.testing.assert_allclose(getattr(t_next, name).numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    assert t_next.itr == int(j_next.itr) == 2


def test_state_to_pytree_resumes_in_the_jax_package():
    """A port `lrs_pnp` state after one outer step, written in the JAX
    layout with a caller's PRNG key, read by the JAX package's
    ``pytree_to_state`` and continued one step in each package; the JAX
    package writes it back to the same layout, which ``pytree_to_state``
    reads as the same state."""
    import jax

    solver = Solver(_sample(), D, _lrs_pnp(tconfig), device="cpu")
    state, _ = solver.step(solver.init_state())
    key = np.asarray(jax.random.PRNGKey(7))
    tree = t_state_to_pytree(state, key)
    assert sorted(tree) == ["X", "itr", "key", "lambda1", "lambda2"]
    assert tree["key"].dtype == np.uint32 and tree["itr"].dtype == np.int32
    j_state = j_pytree_to_state(tree)
    for name, value in state_to_pytree(j_state).items():
        np.testing.assert_array_equal(value, tree[name])
    back = pytree_to_state(state_to_pytree(j_state), torch.Generator().manual_seed(0))
    assert state_from_jax_pytree is pytree_to_state
    for name in ("X", "lambda1", "lambda2"):
        assert torch.equal(getattr(back, name), getattr(state, name))
    s_j = j_synthetic_sample(height=12, width=12, bands=16, missing=0.1, seed=6)
    j_next, _ = JSolver(s_j, D, _lrs_pnp(jconfig)).step(j_state)
    t_next, _ = solver.step(state)
    for name in ("X", "lambda1", "lambda2"):
        ref = np.asarray(getattr(j_next, name))
        np.testing.assert_allclose(getattr(t_next, name).numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    assert t_next.itr == int(j_next.itr) == 2


def test_metric_logger(tmp_path, capsys):
    path = str(tmp_path / "m.jsonl")
    log = MetricLogger(path, echo=True)
    log.log(iter=0, mpsnr=33.0)
    log.log(iter=1, mpsnr=34.5)
    log.close()
    lines = [json.loads(line) for line in open(path)]
    assert lines[1]["mpsnr"] == 34.5 and "t" in lines[0]
    assert json.loads(capsys.readouterr().out.splitlines()[0])["iter"] == 0


def test_trace_writes_a_chrome_trace_naming_the_label(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        with annotate("outer_step"):
            torch.ones((8, 8)).sum()
    (path,) = glob.glob(os.path.join(d, "*.json"))
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "outer_step" for e in events)


def test_viz_writers_produce_their_files(tmp_path):
    pytest.importorskip("matplotlib")
    from lrs_pnp_dip_tpu_torch.utils.viz import save_convergence_figure, save_iteration_panel, save_spectrum

    s = _sample()
    solver = Solver(s, D, _lrs_pnp(tconfig), device="cpu")
    st, aux = solver.step(solver.init_state())
    panel = str(tmp_path / "panel.png")
    save_iteration_panel(panel, s, solver, st, aux, band=5)
    assert os.path.getsize(panel) > 1000
    conv = str(tmp_path / "conv.png")
    save_convergence_figure(conv, [1, 2], [1, 2], [1, 2], [33, 34])
    assert os.path.getsize(conv) > 1000
    spec = str(tmp_path / "spec.npy")
    save_spectrum(spec, st.X.reshape(12, 12, 16), pixel=(3, 4))
    np.testing.assert_array_equal(np.load(spec), st.X.reshape(12, 12, 16)[3, 4].numpy())


def test_mse_and_psnr_standard_match_jax():
    rng = np.random.default_rng(2)
    a, b = rng.random((2, 9, 7, 5)).astype(np.float32)
    for peak in (1.0, 255.0):
        np.testing.assert_allclose(float(psnr_standard(torch.from_numpy(a), torch.from_numpy(b), peak=peak)),
                                   float(jmetrics.psnr_standard(jnp.asarray(a), jnp.asarray(b), peak=peak)),
                                   rtol=1e-6)
    np.testing.assert_allclose(float(mse(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jmetrics.mse(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
