"""The port's device-resident solve on the CPU, where its bodies run eagerly:
the chunked DIP fit, ``Solver.run_scanned``, the seed ensemble's
``run_scanned`` / ``run_chunked`` and ``solve_tiled(scan=True)``, against
the host-stepped loops and the JAX package.

Against the host-stepped loops the bits are equal: the same operations run
in the same order (the chunked fit's extra iterations after the stop are
masked), and the DIP fit's Adam, written out on a flat buffer, gives
``torch.optim.Adam``'s bits.  Against the JAX package: ``run_scanned`` of
``lrs_pnp`` at ``tests/test_solver.py:116``'s tolerances (X atol 1e-5,
MPSNR 1e-3); the chunked fit from a transplanted init at
``tests/test_torch_dip.py``'s (rtol 1e-3 / atol 1e-5: Adam amplifies the
convolutions' f32 ordering differences); two `dip` steps, each from the JAX
step's own input state, at ``tests/test_torch_solver.py``'s (rtol 1e-4 /
atol 1e-4 of the scale on the state, MPSNR 1e-3, SSIM 1e-4, ``dip_iters``
exactly).  A 12x12x16 cube, blocks of 6, a 36x48 dictionary."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from lrs_pnp_dip_tpu.data.masks import synthetic_sample as j_synthetic_sample
from lrs_pnp_dip_tpu.models import Skip as JSkip
from lrs_pnp_dip_tpu.solvers import admm as jadmm
from lrs_pnp_dip_tpu.solvers import dip as jdip
from lrs_pnp_dip_tpu.utils import config as jconfig
from lrs_pnp_dip_tpu_torch.data import synthetic_sample
from lrs_pnp_dip_tpu_torch.models import Skip, skip_params_from_flax
from lrs_pnp_dip_tpu_torch.solvers import (
    FIT_CHUNK, DipFit, SeedEnsembleSolver, Solver, solve_tiled, update_early_stop,
)
from lrs_pnp_dip_tpu_torch.solvers.early_stop import init_early_stop
from lrs_pnp_dip_tpu_torch.utils import config as tconfig

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

NET = dict(num_output_channels=8, channels_down=(8, 8), channels_up=(8, 8), channels_skip=(4, 4),
           pad="reflection")
NET16 = dict(NET, num_output_channels=16)
SPARSE = dict(n_iter=20)
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


def _fit_inputs(seed=5, channels=8):
    rng = np.random.default_rng(seed)
    x, t = (rng.random((1, 12, 12, channels), dtype=np.float32) for _ in range(2))
    m = (rng.random((1, 12, 12, 1)) > 0.15).astype(np.float32)
    return x, t, m


def _init(net, seed):
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return {k: v.clone() for k, v in net.state_dict().items()}


def _reference_fit(net, cfg, x, t, m, init):
    """The DIP fit with ``torch.optim.Adam``, stepped from the host."""
    net.load_state_dict(init)
    net.train()
    opt = torch.optim.Adam(list(net.parameters()), lr=cfg.learning_rate)
    es = init_early_stop(cfg.buffer_size, t.numel(), incremental=cfg.es_mode == "incremental")
    bf16 = cfg.compute_dtype == "bfloat16"
    net_input = x.to(torch.bfloat16) if bf16 else x
    out, loss, i = torch.zeros_like(t), torch.tensor(float("inf")), 0
    while not bool(es.stop) and i < cfg.num_iter:
        if bf16:
            cast = {k: p.to(torch.bfloat16) for k, p in net.named_parameters()}
            pred = torch.func.functional_call(net, cast, (net_input,)).to(torch.float32)
        else:
            pred = net(net_input)
        loss_t = torch.mean((t * m - pred * m) ** 2)
        opt.zero_grad(set_to_none=True)
        loss_t.backward()
        opt.step()
        out, loss = pred.detach(), loss_t.detach()
        if i % cfg.show_every == 0:
            update_early_stop(es, out.reshape(-1), i, cfg.patience)
        i += 1
    return out, loss, i, bool(es.stop)


@pytest.mark.parametrize("cfg", [
    tconfig.DipConfig(**DIP),
    tconfig.DipConfig(num_iter=12, learning_rate=0.1, buffer_size=4, patience=50),
    tconfig.DipConfig(**dict(DIP, es_mode="incremental", num_iter=30)),
    tconfig.DipConfig(**dict(DIP, compute_dtype="bfloat16")),
], ids=["early_stop", "cap_lr0.1", "incremental", "bf16"])
def test_dip_fit_gives_torch_adam_bits(cfg):
    """The fit's Adam on one flat buffer, masked by ``active``, equals
    ``torch.optim.Adam`` stepped from the host, bit for bit."""
    x, t, m = (torch.from_numpy(a) for a in _fit_inputs())
    init = _init(Skip(num_input_channels=8, **NET), 2)
    ref = _reference_fit(Skip(num_input_channels=8, **NET), cfg, x, t, m, init)
    got = DipFit(Skip(num_input_channels=8, **NET), cfg)(x, t, m, init=init)
    assert (got.n_iters, got.stopped) == ref[2:]
    assert torch.equal(got.out, ref[0]) and torch.equal(got.loss, ref[1])


@pytest.mark.parametrize("chunk", [1, 3, 7])
@pytest.mark.parametrize("cfg", [
    tconfig.DipConfig(**DIP),
    tconfig.DipConfig(num_iter=10, learning_rate=0.05, buffer_size=3, patience=100),
    tconfig.DipConfig(**dict(DIP, num_iter=40, buffer_size=4, return_mode="window_mean", show_every=2)),
], ids=["early_stop", "num_iter_cap", "window_mean"])
def test_chunked_fit_equals_the_host_stepped_fit(cfg, chunk):
    """Replayed ``chunk`` iterations per read of the stop flag: the same
    iteration count, stop, output and loss, bit for bit; the iterations
    past the stop or the cap change nothing; and the fit reads the host
    once per chunk, nothing inside one."""
    x, t, m = (torch.from_numpy(a) for a in _fit_inputs())
    fit = DipFit(Skip(num_input_channels=8, **NET), cfg)
    gen = torch.Generator()
    host = fit(x, t, m, generator=gen.manual_seed(0))
    with CountHostReads() as mode:
        got = fit(x, t, m, generator=gen.manual_seed(0), chunk=chunk)
    assert (got.n_iters, got.stopped) == (host.n_iters, host.stopped)
    assert torch.equal(got.out, host.out) and torch.equal(got.loss, host.loss)
    assert mode.reads == ["tolist"] * -(-got.n_iters // chunk)
    if cfg.num_iter == 10:
        assert got.n_iters == 10 and not got.stopped
    else:
        assert got.stopped


def test_chunked_fit_matches_jax_with_transplanted_init():
    """As ``tests/test_torch_dip.py``'s transplanted fit, through the chunked path."""
    x, t, m = _fit_inputs()
    cfg = tconfig.DipConfig(num_iter=40, buffer_size=3, patience=2, learning_rate=0.01)
    fnet = JSkip(**NET)
    key = jax.random.PRNGKey(7)
    params = jax.tree.map(np.asarray, jax.jit(fnet.init)(key, jnp.asarray(x))["params"])
    ref = jax.jit(jdip.make_dip_fit(fnet, jdip.DipConfig(**cfg.__dict__)))(
        key, jnp.asarray(x), jnp.asarray(t), jnp.asarray(m)
    )
    res = DipFit(Skip(num_input_channels=8, **NET), cfg)(
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(m),
        init=skip_params_from_flax(params), chunk=FIT_CHUNK,
    )
    assert res.n_iters == int(ref.n_iters) and res.stopped == bool(ref.stopped) is True
    np.testing.assert_allclose(float(res.loss), float(ref.loss), rtol=1e-3)
    np.testing.assert_allclose(res.out.numpy(), np.asarray(ref.out), rtol=1e-3, atol=1e-5)


def _lrs_configs():
    kw = dict(variant="lrs_pnp", outer_iters=3, block_size=6, stride=6, dip=None)
    return (tconfig.SolverConfig(sparse=tconfig.SparseProxConfig(n_iter=4), **kw),
            jconfig.SolverConfig(sparse=jconfig.SparseProxConfig(n_iter=4), **kw))


def test_run_scanned_equals_run_and_the_jax_scan():
    t_cfg, j_cfg = _lrs_configs()
    D = _dictionary()
    sample = synthetic_sample(12, 12, 16, missing=0.1, seed=8)
    solver = Solver(sample, D, t_cfg, device="cpu")
    loop_state, loop_hist = solver.run()
    scan_state, scan_hist = solver.run_scanned()
    assert torch.equal(scan_state.X, loop_state.X) and torch.equal(scan_state.lambda1, loop_state.lambda1)
    assert torch.equal(scan_state.lambda2, loop_state.lambda2) and scan_state.itr == 3
    assert set(scan_hist) == {"mpsnr", "ssim", "x_dist", "l1_dist", "l2_dist", "dip_iters"}
    for k, v in scan_hist.items():
        assert v.shape == (3,)
        np.testing.assert_array_equal(v, np.asarray(loop_hist[k], v.dtype))
    assert scan_hist["dip_iters"].dtype == np.int32 and not scan_hist["dip_iters"].any()
    # from a given state, the steps go on where they left off
    more_state, _ = solver.run_scanned(2, state=scan_state)
    ref_state, _ = solver.run(2, state=loop_state)
    assert torch.equal(more_state.X, ref_state.X) and more_state.itr == 5
    j_solver = jadmm.Solver(j_synthetic_sample(12, 12, 16, missing=0.1, seed=8), D, j_cfg)
    j_state, j_hist = j_solver.run_scanned()
    np.testing.assert_allclose(scan_state.X.numpy(), np.asarray(j_state.X), atol=1e-5)
    np.testing.assert_allclose(scan_hist["mpsnr"], j_hist["mpsnr"], atol=1e-3)


def test_two_scanned_dip_steps_match_jax_step_by_step():
    """Each outer step of ``run_scanned`` from the JAX step's input state and
    the JAX step's DIP init (``tests/test_torch_solver.py``)."""
    kw = dict(variant="dip", mu1=0.1, mu2=0.1, outer_iters=2, block_size=6, stride=6)
    t_cfg = tconfig.SolverConfig(sparse=tconfig.SparseProxConfig(**SPARSE), dip=tconfig.DipConfig(**DIP), **kw)
    j_cfg = jconfig.SolverConfig(sparse=jconfig.SparseProxConfig(**SPARSE), dip=jconfig.DipConfig(**DIP), **kw)
    D = _dictionary()
    s_j = j_synthetic_sample(12, 12, 16, missing=0.1, seed=3)
    fnet = JSkip(**NET16)
    j_step = jax.jit(jadmm.build_step(j_cfg, s_j.shape, net=fnet))
    j_consts = jadmm.make_consts(s_j, D, j_cfg)
    j_state = jadmm.init_state(s_j, seed=0)
    inits, key = [], j_state.key
    for _ in range(2):
        key, dip_key = jax.random.split(key)
        fit_key, _ = jax.random.split(dip_key)
        params = fnet.init(fit_key, jnp.zeros((1, 12, 12, 16), jnp.float32))["params"]
        inits.append(skip_params_from_flax(jax.tree.map(np.asarray, params)))
    solver = Solver(
        synthetic_sample(12, 12, 16, missing=0.1, seed=3), D, t_cfg,
        net=Skip(num_input_channels=16, **NET16), device="cpu", dip_init=lambda itr: inits[itr],
    )
    t_state = solver.init_state()
    for _ in range(2):
        t_state = t_state._replace(**{
            k: torch.from_numpy(np.array(getattr(j_state, k))) for k in ("X", "lambda1", "lambda2")
        })
        j_state, j_aux = j_step(j_state, j_consts)
        t_state, hist = solver.run_scanned(1, state=t_state)
        assert hist["dip_iters"][0] == int(j_aux.dip_iters)
        np.testing.assert_allclose(hist["mpsnr"][0], float(j_aux.mpsnr), atol=1e-3)
        np.testing.assert_allclose(hist["ssim"][0], float(j_aux.ssim), atol=1e-4)
        for name in ("X", "lambda1", "lambda2"):
            ref = np.asarray(getattr(j_state, name))
            np.testing.assert_allclose(
                getattr(t_state, name).numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max()
            )
    assert 0 < hist["dip_iters"][0] < 20  # the early stop fired


@pytest.mark.parametrize("variant", ["lrs_pnp", "dip"])
def test_ensemble_run_chunked_equals_run_scanned_and_run(variant):
    """``run_chunked(5, chunk=2)`` runs chunks of 2, 2 and 1 with one host
    read of the history each (``tests/test_parallel.py:261``), and equals
    ``run_scanned(5)`` and the host-stepped ``run(5)`` bit for bit."""
    kw = dict(variant=variant, outer_iters=5, block_size=6, stride=6)
    if variant == "lrs_pnp":
        cfg = tconfig.SolverConfig(sparse=tconfig.SparseProxConfig(n_iter=4), dip=None, **kw)
        net = None
    else:
        cfg = tconfig.SolverConfig(sparse=tconfig.SparseProxConfig(n_iter=4),
                                   dip=tconfig.DipConfig(**dict(DIP, num_iter=6)), **kw)
        net = Skip(num_input_channels=16, **NET16)
    ens = SeedEnsembleSolver(synthetic_sample(12, 12, 16, missing=0.1, seed=21), _dictionary(), cfg,
                             seeds=[3, 11], net=net, device="cpu")
    loop_state, loop_hist = ens.run(5)
    scan_state, scan_hist = ens.run_scanned(5)
    with CountHostReads() as mode:
        chunk_state, chunk_hist = ens.run_chunked(5, chunk=2)
    if variant == "lrs_pnp":
        assert mode.reads == ["cpu", "numpy"] * 3  # one copy of the history per chunk
    for state, hist in ((scan_state, scan_hist), (chunk_state, chunk_hist)):
        assert torch.equal(state.X, loop_state.X) and state.itr == 5
        assert set(hist) == {"mpsnr", "ssim", "dip_iters", "ens_mpsnr", "ens_ssim"}
        for k in hist:
            assert hist[k].shape == ((5, 2) if k in ("mpsnr", "ssim", "dip_iters") else (5,))
            assert hist[k].dtype == loop_hist[k].dtype
            np.testing.assert_array_equal(hist[k], loop_hist[k])
    with pytest.raises(ValueError, match="chunk"):
        ens.run_chunked(5, chunk=0)


@pytest.mark.parametrize("variant", ["lrs_pnp", "dip"])
def test_solve_tiled_scan_equals_the_host_loop(variant):
    """A 24x30 scene in tiles of 12x12 with overlap 6 (12 tiles, batches of
    5: the last one partial), ``scan=True`` against ``scan=False``."""
    scene = synthetic_sample(24, 30, 16, seed=2)
    kw = dict(variant=variant, block_size=6, stride=6, sparse=tconfig.SparseProxConfig(n_iter=4))
    cfg = tconfig.SolverConfig(dip=None if variant == "lrs_pnp" else tconfig.DipConfig(**dict(DIP, num_iter=5)), **kw)
    net = None if variant == "lrs_pnp" else Skip(num_input_channels=16, **NET16)
    out = {
        scan: solve_tiled(scene.noisy, scene.mask, _dictionary(), cfg, tile_shape=(12, 12), tile_batch=5,
                          overlap=6, n_iters=2, net=net, scan=scan, device="cpu")
        for scan in (True, False)
    }
    assert out[True].shape == (24, 30, 16) and np.isfinite(out[True]).all()
    np.testing.assert_array_equal(out[True], out[False])


def test_inpaint_scene_takes_the_jax_packages_scan_default(monkeypatch):
    """``scan=None`` is the device-resident loop for `lrs_pnp` and the host
    loop for the DIP variants, as ``lrs_pnp_dip_tpu.api.inpaint_scene``."""
    from lrs_pnp_dip_tpu_torch import api
    from lrs_pnp_dip_tpu_torch.solvers import tiled

    seen = []
    monkeypatch.setattr(tiled, "solve_tiled", lambda *a, scan, **k: seen.append(scan))
    scene = synthetic_sample(12, 12, 16, seed=2)
    D = np.random.default_rng(0).standard_normal((36 * 36, 512)).astype(np.float32)
    for variant, scan in (("lrs_pnp", None), ("dip", None), ("dip", True), ("lrs_pnp", False)):
        api.inpaint_scene(scene.noisy, scene.mask, variant=variant, dictionary=D, scan=scan, device="cpu")
    assert seen == [True, False, True, False]


def test_scanned_solve_refuses_a_fit_it_cannot_replay():
    from lrs_pnp_dip_tpu_torch.solvers import OuterStages, ScannedSolve, make_consts

    cfg = dataclasses.replace(tconfig.SolverConfig(block_size=6, stride=6), dip=tconfig.DipConfig(**DIP))
    sample = synthetic_sample(12, 12, 16, missing=0.1, seed=3)
    stages = OuterStages(cfg, sample.shape, net=Skip(num_input_channels=16, **NET16), device="cpu",
                         dip_fit_factory=lambda net, dip_cfg: (lambda *a, **k: None))
    with pytest.raises(ValueError, match="DIP fit"):
        ScannedSolve(stages, make_consts(sample, _dictionary(), cfg, device="cpu"))
