"""Two full `dip` outer steps of the port against the JAX package.

A 12x12x16 synthetic cube, block_size = stride = 6 (72 blocks, with the
band-start append rule), a random column-normalised 36x48 dictionary, a
small skip net passed as ``net=``, and each outer step's DIP starting from
the JAX step's own init (the same PRNG splits as ``build_step``), carried
over by ``skip_params_from_flax`` through ``dip_init``.  Each outer step
also starts from the JAX step's input state (X, lambda1, lambda2): chained,
the second step's DIP input differs by some 3e-6 and its fit carries that
to 1e-3 of U's scale, past the one-step tolerance on some hosts.

The DIP fits are short (lr 0.01, window 3, patience 2: the early stop
fires in both steps) because Adam amplifies f32 ordering differences: its
first step moves every parameter by lr * sign(grad), so a parameter whose
gradient is at rounding level moves either way.  Measured on this
problem: after 12 iterations at lr 0.1 the DIP outputs already differ by
3%, so only short fits can be compared value for value.

Tolerances: X, lambda1, lambda2 within rtol 1e-4 / atol 1e-4 of their
scale (measured 7e-6), MPSNR within 1e-3 dB and SSIM within 1e-4;
``dip_iters`` exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.data.masks import synthetic_sample as j_synthetic_sample
from lrs_pnp_dip_tpu.models import Skip as JSkip
from lrs_pnp_dip_tpu.solvers import admm as jadmm
from lrs_pnp_dip_tpu.utils import config as jconfig
from lrs_pnp_dip_tpu_torch import inpaint, inpaint_scene
from lrs_pnp_dip_tpu_torch.data import synthetic_sample
from lrs_pnp_dip_tpu_torch.models import Skip, skip_params_from_flax
from lrs_pnp_dip_tpu_torch.solvers import Solver, SolverDiverged, StepAux
from lrs_pnp_dip_tpu_torch.utils import config as tconfig

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

NET = dict(
    num_output_channels=16,
    channels_down=(8, 8),
    channels_up=(8, 8),
    channels_skip=(4, 4),
    pad="reflection",
)


def _configs():
    kw = dict(variant="dip", mu1=0.1, mu2=0.1, outer_iters=2, block_size=6, stride=6)
    t = tconfig.SolverConfig(
        sparse=tconfig.SparseProxConfig(n_iter=20),
        dip=tconfig.DipConfig(num_iter=20, buffer_size=3, patience=2, learning_rate=0.01),
        **kw,
    )
    j = jconfig.SolverConfig(
        sparse=jconfig.SparseProxConfig(n_iter=20),
        dip=jconfig.DipConfig(num_iter=20, buffer_size=3, patience=2, learning_rate=0.01),
        **kw,
    )
    return t, j


def _dictionary():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((36, 48)).astype(np.float32)
    return D / np.linalg.norm(D, axis=0, keepdims=True)


def test_two_dip_outer_steps_match_jax():
    t_cfg, j_cfg = _configs()
    D = _dictionary()
    s_t = synthetic_sample(12, 12, 16, missing=0.1, seed=3)
    s_j = j_synthetic_sample(12, 12, 16, missing=0.1, seed=3)

    fnet = JSkip(**NET)
    j_step = jax.jit(jadmm.build_step(j_cfg, s_j.shape, net=fnet))
    j_consts = jadmm.make_consts(s_j, D, j_cfg)
    j_state = jadmm.init_state(s_j, seed=0)

    # the JAX step's DIP init at each outer step: state.key -> dip_key -> fit_key
    inits, key = [], j_state.key
    for _ in range(2):
        key, dip_key = jax.random.split(key)
        fit_key, _ = jax.random.split(dip_key)
        params = fnet.init(fit_key, jnp.zeros((1, 12, 12, 16), jnp.float32))["params"]
        inits.append(skip_params_from_flax(jax.tree.map(np.asarray, params)))

    solver = Solver(
        s_t, D, t_cfg, net=Skip(num_input_channels=16, **NET), device="cpu",
        dip_init=lambda itr: inits[itr],
    )
    t_state = solver.init_state()
    for _ in range(2):
        # each step from the JAX step's own input state, so that the step,
        # not the chained DIP trajectory, is held to the tolerance
        t_state = t_state._replace(**{
            k: torch.from_numpy(np.array(getattr(j_state, k))) for k in ("X", "lambda1", "lambda2")
        })
        j_state, j_aux = j_step(j_state, j_consts)
        t_state, t_aux = solver.step(t_state)
        assert t_aux.dip_iters == int(j_aux.dip_iters)
        np.testing.assert_allclose(float(t_aux.mpsnr), float(j_aux.mpsnr), atol=1e-3)
        np.testing.assert_allclose(float(t_aux.ssim), float(j_aux.ssim), atol=1e-4)
        for ours, ref in (
            (t_state.X, j_state.X),
            (t_state.lambda1, j_state.lambda1),
            (t_state.lambda2, j_state.lambda2),
        ):
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                ours.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max()
            )
    assert 0 < t_aux.dip_iters < 20  # the early stop fired


def test_solver_run_tracks_best_and_detects_divergence():
    t_cfg, _ = _configs()
    s = synthetic_sample(12, 12, 16, missing=0.1, seed=4)
    solver = Solver(s, _dictionary(), t_cfg, net=Skip(num_input_channels=16, **NET), device="cpu")
    state, hist = solver.run()
    assert len(hist["mpsnr"]) == 2 and np.isfinite(hist["mpsnr"]).all()
    assert hist["best_mpsnr"] == max(hist["mpsnr"])
    assert solver.result_cube(state).shape == (12, 12, 16)

    def fake_step(x_dist):
        def step(st):
            zero = torch.zeros(())
            return st, StepAux(
                mpsnr=torch.tensor(30.0), ssim=torch.tensor(0.9), x_dist=x_dist(st),
                l1_dist=zero, l2_dist=zero, dip_iters=0, dip_loss=zero,
                U=st.X, phi_scatter=st.X,
            )

        return step

    solver.step = fake_step(lambda st: torch.log(torch.linalg.norm(st.X - st.X)))
    with pytest.raises(SolverDiverged, match="stalled"):
        solver.run(2)
    solver.step = fake_step(lambda st: torch.tensor(float("nan")))
    with pytest.raises(SolverDiverged, match="non-finite"):
        solver.run(2)


def _short(cfg):
    """A preset cut to a few sparse and DIP iterations."""
    sparse = dataclasses.replace(cfg.sparse, n_iter=5)
    dip = cfg.dip and dataclasses.replace(cfg.dip, num_iter=4, buffer_size=3)
    return dataclasses.replace(cfg, sparse=sparse, dip=dip)


@pytest.mark.parametrize(
    "variant", ["lrs_pnp", "dip", "dip_1lip", "dip_tuned", "dip_1lip_tuned", "dip_fast"]
)
def test_every_ported_preset_runs_through_inpaint_on_the_cpu(variant):
    """Each preset's own net (skip-128, or the Lipschitz U-Net at width 8)
    on a 36x36x16 cube: a single solve and a two-seed ensemble."""
    s = synthetic_sample(36, 36, 16, missing=0.1, seed=5)
    cfg = _short(tconfig.PRESETS[variant](block_size=6, stride=6, net_width=8))
    cube, hist = inpaint(s.noisy, s.mask, config=cfg, clean=s.clean, dictionary=_dictionary(),
                         n_iters=2, device="cpu")
    assert cube.shape == (36, 36, 16) and np.isfinite(cube).all()
    assert len(hist["mpsnr"]) == 2 and np.isfinite(hist["mpsnr"]).all()
    assert hist["dip_iters"] == ([0.0, 0.0] if variant == "lrs_pnp" else [4.0, 4.0])
    ens_cube, ens = inpaint(s.noisy, s.mask, config=cfg, clean=s.clean, dictionary=_dictionary(),
                            n_iters=1, seeds=[0, 1], device="cpu")
    assert ens_cube.shape == (36, 36, 16) and np.isfinite(ens_cube).all()
    assert ens["mpsnr"].shape == (1, 2) and ens["ens_mpsnr"].shape == (1,)
    if variant == "lrs_pnp":  # deterministic: both seeds are the single solve
        np.testing.assert_allclose(ens["mpsnr"][0], [hist["mpsnr"][0]] * 2, atol=1e-4)
    else:
        assert ens["mpsnr"][0, 0] != ens["mpsnr"][0, 1]


def test_inpaint_on_cpu_and_unported_entry_points():
    """The `matlab` preset (nlm_classic) and the bm3d denoiser run through
    ``inpaint``; so does a missing dictionary at block_size != 36, through
    ``inpaint`` and ``inpaint_scene`` alike: both learn one from the observed
    pixels (tests/test_torch_api_auto.py holds them to the JAX package).  An
    unknown variant raises."""
    s = synthetic_sample(12, 12, 16, missing=0.1, seed=5)
    kw = dict(dictionary=_dictionary(), device="cpu", block_size=6, stride=6)
    cube, hist = inpaint(s.noisy, s.mask, variant="matlab", clean=s.clean, n_iters=2, **kw)
    assert cube.shape == (12, 12, 16) and np.isfinite(cube).all() and len(hist["mpsnr"]) == 2
    bm3d = tconfig.lrs_pnp_preset(
        block_size=6, stride=6, sparse=tconfig.SparseProxConfig(n_iter=3, denoiser="bm3d"))
    cube, hist = inpaint(s.noisy, s.mask, config=bm3d, dictionary=_dictionary(), device="cpu")
    assert cube.shape == (12, 12, 16) and np.isfinite(cube).all() and len(hist["mpsnr"]) == 2
    cube, hist = inpaint(s.noisy, s.mask, variant="lrs_pnp", clean=s.clean, device="cpu", block_size=6, stride=6)
    assert cube.shape == (12, 12, 16) and np.isfinite(cube).all() and len(hist["mpsnr"]) == 2
    scene = inpaint_scene(s.noisy, s.mask, device="cpu", block_size=6, stride=6, tile_shape=(12, 12))
    assert scene.shape == (12, 12, 16) and np.isfinite(scene).all()
    with pytest.raises(ValueError, match="unknown variant"):
        inpaint(s.noisy, s.mask, config=tconfig.SolverConfig(variant="tv", block_size=6, stride=6),
                dictionary=_dictionary(), device="cpu")
