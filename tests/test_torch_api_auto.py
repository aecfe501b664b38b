"""The slice as a whole: ``inpaint`` and ``inpaint_scene`` without a
dictionary, at a block size other than 36, so each package learns its own
from the observed pixels, against the JAX package.

Each package's ten MOD steps drift apart within f32's rounding of an
ill-conditioned solve (tests/test_torch_dictionary.py: 3.3e-2 of an atom's
largest entry on this problem), and the cubes carry that drift: measured
5.2e-3 of max|X| for the 16x16x24 `lrs_pnp` solve and 3.4e-2 for the
32x24x16 scene (its probe learns from the whole scene).  So each test holds
three things apart:
  * the port's solve without a dictionary is its solve with the dictionary
    its ``_auto_dictionary`` learns, exactly;
  * the JAX solve fed that same dictionary agrees with the port within the
    solve's own tolerance, 1e-4 of max|X| (tests/test_torch_solver.py);
  * the two packages end to end: within 2e-2 (single solve) and 1e-1
    (scene) of max|X|, and their MPSNR within 2e-3 dB and 5e-2 dB (measured
    6.6e-4 and 2.2e-2 dB).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import lrs_pnp_dip_tpu as lrs
from lrs_pnp_dip_tpu import api as japi
from lrs_pnp_dip_tpu.data.io import HsiSample as JHsiSample
from lrs_pnp_dip_tpu.data.masks import synthetic_sample as j_synthetic_sample
from lrs_pnp_dip_tpu.models import Skip as JSkip
from lrs_pnp_dip_tpu.ops.metrics import mpsnr as j_mpsnr
from lrs_pnp_dip_tpu.solvers import admm as jadmm
from lrs_pnp_dip_tpu.utils import config as jconfig
from lrs_pnp_dip_tpu_torch import api as tapi
from lrs_pnp_dip_tpu_torch import inpaint, inpaint_scene
from lrs_pnp_dip_tpu_torch.data import HsiSample, synthetic_sample
from lrs_pnp_dip_tpu_torch.models import Skip, skip_params_from_flax
from lrs_pnp_dip_tpu_torch.solvers import Solver
from lrs_pnp_dip_tpu_torch.utils import config as tconfig

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

SOLVE_TOL = 1e-4


def _lrs_pnp(mod, n_iter):
    return mod.SolverConfig(
        variant="lrs_pnp", outer_iters=2, block_size=8, stride=8, dip=None, mu1=0.15, mu2=0.9,
        sparse=mod.SparseProxConfig(n_iter=n_iter, alpha_mode="specnorm", h_scale=0.1),
    )


def _rel(ours, ref):
    return float(np.abs(np.asarray(ours) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def test_inpaint_lrs_pnp_learns_its_dictionary_as_jax_does():
    """tests/test_api.py's test_inpaint_one_call_auto_dictionary problem."""
    s = synthetic_sample(height=16, width=16, bands=24, missing=0.08, seed=21)
    t_cfg, j_cfg = _lrs_pnp(tconfig, 10), _lrs_pnp(jconfig, 10)
    cube, hist = inpaint(s.noisy, s.mask, config=t_cfg, clean=s.clean, device="cpu")
    D = tapi._auto_dictionary(HsiSample(noisy=s.noisy, mask=s.mask), t_cfg, device="cpu")
    assert D.shape == (64, 161)
    same, _ = inpaint(s.noisy, s.mask, config=t_cfg, clean=s.clean, dictionary=D, device="cpu")
    np.testing.assert_array_equal(cube, same)
    fed, _ = lrs.inpaint(s.noisy, s.mask, config=j_cfg, clean=s.clean, dictionary=D)
    assert _rel(cube, fed) < SOLVE_TOL
    ref, j_hist = lrs.inpaint(s.noisy, s.mask, config=j_cfg, clean=s.clean)
    assert _rel(cube, ref) < 2e-2
    np.testing.assert_allclose(hist["mpsnr"], j_hist["mpsnr"], atol=2e-3)
    assert hist["mpsnr"][-1] > float(j_mpsnr(jnp.asarray(s.clean), jnp.asarray(s.noisy)))


def test_inpaint_scene_learns_from_the_central_probe_as_jax_does():
    """tests/test_api.py's test_inpaint_scene_whole_scene_auto_dictionary
    problem: a 32x24x16 scene in 16x8 tiles, two per batch."""
    s = synthetic_sample(height=32, width=24, bands=16, missing=0.06, seed=23)
    t_cfg, j_cfg = _lrs_pnp(tconfig, 8), _lrs_pnp(jconfig, 8)
    tiles = dict(tile_shape=(16, 8), tile_batch=2)
    rec = inpaint_scene(s.noisy, s.mask, config=t_cfg, device="cpu", **tiles)
    D = tapi._auto_dictionary(HsiSample(noisy=s.noisy, mask=s.mask), t_cfg, device="cpu")
    np.testing.assert_array_equal(rec, inpaint_scene(s.noisy, s.mask, config=t_cfg, dictionary=D,
                                                     device="cpu", **tiles))
    fed = lrs.inpaint_scene(s.noisy, s.mask, config=j_cfg, dictionary=D, **tiles)
    assert _rel(rec, fed) < SOLVE_TOL
    ref = lrs.inpaint_scene(s.noisy, s.mask, config=j_cfg, **tiles)
    assert _rel(rec, ref) < 1e-1
    clean = jnp.asarray(s.clean)
    ours, theirs = float(j_mpsnr(clean, jnp.asarray(rec))), float(j_mpsnr(clean, jnp.asarray(ref)))
    assert abs(ours - theirs) < 5e-2
    assert ours > float(j_mpsnr(clean, jnp.asarray(s.noisy)))


def test_inpaint_scene_probe_is_the_central_crop(monkeypatch):
    """A scene wider than 128 pixels learns from its central 128-pixel crop,
    as the JAX package's inpaint_scene does."""
    s = synthetic_sample(height=8, width=136, bands=12, missing=0.05, seed=24)
    cfg = tconfig.lrs_pnp_preset(block_size=4, stride=4, sparse=tconfig.SparseProxConfig(n_iter=2))
    seen = []
    real = tapi._auto_dictionary
    monkeypatch.setattr(
        tapi, "_auto_dictionary", lambda probe, config, **kw: seen.append(probe) or real(probe, config, **kw))
    inpaint_scene(s.noisy, s.mask, config=cfg, tile_shape=(8, 8), tile_batch=17, n_iters=1, device="cpu")
    (probe,) = seen
    np.testing.assert_array_equal(probe.noisy, s.noisy[:, 4:132])
    np.testing.assert_array_equal(probe.mask, s.mask[:, 4:132])


NET = dict(num_output_channels=24, channels_down=(4,), channels_up=(4,), channels_skip=(2,), pad="reflection")


def test_one_dip_outer_step_through_the_auto_path_matches_jax():
    """One `dip` outer step on the 16x16x24 problem, each package with the
    dictionary it learns itself, the port's DIP starting from the JAX
    step's own init (transplanted).  The DIP prox does not see the
    dictionary, the sparse prox does: X within 2e-2 of max|X| (the learning
    drift, as in the lrs_pnp test), the DIP iterations equal, and the same
    step fed the port's dictionary within 1e-4."""
    s_t = synthetic_sample(16, 16, 24, missing=0.08, seed=21)
    s_j = j_synthetic_sample(16, 16, 24, missing=0.08, seed=21)
    kw = dict(variant="dip", mu1=0.1, mu2=0.1, outer_iters=1, block_size=8, stride=8)
    t_cfg = tconfig.SolverConfig(
        sparse=tconfig.SparseProxConfig(n_iter=20),
        dip=tconfig.DipConfig(num_iter=20, buffer_size=3, patience=2, learning_rate=0.01), **kw)
    j_cfg = jconfig.SolverConfig(
        sparse=jconfig.SparseProxConfig(n_iter=20),
        dip=jconfig.DipConfig(num_iter=20, buffer_size=3, patience=2, learning_rate=0.01), **kw)
    D_t = tapi._auto_dictionary(HsiSample(noisy=s_t.noisy, mask=s_t.mask), t_cfg, device="cpu")
    D_j = japi._auto_dictionary(JHsiSample(noisy=s_j.noisy, mask=s_j.mask, clean=None), j_cfg)

    fnet = JSkip(**NET)
    j_step = jax.jit(jadmm.build_step(j_cfg, s_j.shape, net=fnet))
    j_state = jadmm.init_state(s_j, seed=0)
    _, dip_key = jax.random.split(j_state.key)
    fit_key, _ = jax.random.split(dip_key)
    params = jax.jit(fnet.init)(fit_key, jnp.zeros((1, 16, 16, 24), jnp.float32))["params"]
    init = skip_params_from_flax(jax.tree.map(np.asarray, params))

    solver = Solver(s_t, D_t, t_cfg, net=Skip(num_input_channels=24, **NET), device="cpu",
                    dip_init=lambda itr: init)
    t_state, t_aux = solver.step(solver.init_state())
    fed, fed_aux = j_step(j_state, jadmm.make_consts(s_j, D_t, j_cfg))
    ref, ref_aux = j_step(j_state, jadmm.make_consts(s_j, D_j, j_cfg))
    assert t_aux.dip_iters == int(fed_aux.dip_iters) == int(ref_aux.dip_iters)
    assert _rel(t_state.X.numpy(), fed.X) < SOLVE_TOL
    assert _rel(t_state.X.numpy(), ref.X) < 2e-2
