"""The port's soft threshold, SVT and `lrs_pnp` solve against the JAX package.

Tolerances.  ``svt_gram`` against the SVD route in f64: rtol 1e-9 (the two
are the same operator).  Against the JAX ``svt_gram`` in f32: atol 2e-5 of
max |X| — the eigenvalues of an f32 Gram carry about 1e-7 * lambda_max of
absolute error, so a singular value s near tau shrinks with an error of about
1e-7 * s_max^2 / s in either package.  The full-width two-iteration
`lrs_pnp` solve: X within 1e-4 of its scale, MPSNR within 1e-3 dB, SSIM
within 1e-4 (measured 1.3e-5, 4e-6 dB and 9e-8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.data.masks import synthetic_sample as j_synthetic_sample
from lrs_pnp_dip_tpu.ops import shrinkage as jshrink
from lrs_pnp_dip_tpu.ops.svt import singular_energy_ratio as j_singular_energy_ratio
from lrs_pnp_dip_tpu.ops.svt import singular_values_gram as j_singular_values_gram
from lrs_pnp_dip_tpu.ops.svt import svt as j_svt
from lrs_pnp_dip_tpu.ops.svt import svt_gram as j_svt_gram
from lrs_pnp_dip_tpu.solvers import admm as jadmm
from lrs_pnp_dip_tpu.utils import config as jconfig
from lrs_pnp_dip_tpu_torch import inpaint
from lrs_pnp_dip_tpu_torch.data import load_trained_dictionary, synthetic_sample
from lrs_pnp_dip_tpu_torch.ops import (
    singular_energy_ratio, singular_values_gram, soft_threshold, svt, svt_gram,
)
from lrs_pnp_dip_tpu_torch.solvers import Solver, solve
from lrs_pnp_dip_tpu_torch.utils import config as tconfig

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)


def _low_rank(rng, p=200, b=16, rank=4, noise=0.05, batch=()):
    X = rng.standard_normal(batch + (p, rank)) @ rng.standard_normal(batch + (rank, b))
    return (X + noise * rng.standard_normal(batch + (p, b))).astype(np.float32)


def test_soft_threshold_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 33)).astype(np.float32)
    x[0, :3] = (0.3, -0.3, 0.0)  # at the threshold, and zero
    ours = soft_threshold(torch.from_numpy(x), 0.3).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jshrink.soft_threshold(jnp.asarray(x), 0.3)))


@pytest.mark.parametrize("tau", [0.5, 3.0, 1e3], ids=["small", "mid", "kills_all"])
def test_svt_gram_equals_svd_route_in_f64(tau):
    X = torch.from_numpy(_low_rank(np.random.default_rng(1))).to(torch.float64)
    np.testing.assert_allclose(
        svt_gram(X, tau).numpy(), svt(X, tau).numpy(), rtol=1e-9, atol=1e-9
    )
    if tau == 1e3:
        assert float(svt_gram(X, tau).abs().max()) == 0.0


@pytest.mark.parametrize("batch", [(), (3,)], ids=["single", "batched"])
def test_svt_routes_match_jax_in_f32(batch):
    X = _low_rank(np.random.default_rng(2), batch=batch)
    tau = 1.0 / 0.9
    atol = 2e-5 * np.abs(X).max()
    ours = svt_gram(torch.from_numpy(X), tau).numpy()
    ours_svd = svt(torch.from_numpy(X), tau).numpy()
    lanes = X if batch else X[None]
    ref = np.stack([np.asarray(j_svt_gram(jnp.asarray(x), tau)) for x in lanes])
    ref_svd = np.stack([np.asarray(j_svt(jnp.asarray(x), tau)) for x in lanes])
    np.testing.assert_allclose(ours.reshape(ref.shape), ref, atol=atol, rtol=0)
    np.testing.assert_allclose(ours_svd.reshape(ref.shape), ref_svd, atol=atol, rtol=0)


def test_svt_gram_zero_ratio_on_null_directions():
    """A zero singular value gives ratio 0, not 0/0: an all-zero X (and a
    rank-deficient one) comes back finite."""
    assert float(svt_gram(torch.zeros((12, 4)), 0.1).abs().max()) == 0.0
    X = torch.from_numpy(_low_rank(np.random.default_rng(3), rank=2, noise=0.0))
    assert bool(torch.isfinite(svt_gram(X, 0.1)).all())


def test_singular_values_and_energy_ratio_match():
    X = _low_rank(np.random.default_rng(4))
    s = singular_values_gram(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(
        s, np.asarray(j_singular_values_gram(jnp.asarray(X))), rtol=1e-3, atol=1e-3
    )
    np.testing.assert_allclose(s, np.linalg.svd(X, compute_uv=False), rtol=1e-3, atol=1e-3)
    for p in (2, 5):
        np.testing.assert_allclose(
            float(singular_energy_ratio(torch.from_numpy(X), p)),
            float(j_singular_energy_ratio(jnp.asarray(X), p)), rtol=1e-5,
        )
    batched = torch.from_numpy(np.stack([X, 2 * X]))
    np.testing.assert_allclose(singular_values_gram(batched)[1].numpy(), 2 * s, rtol=1e-4, atol=1e-3)


def test_full_width_lrs_pnp_preset_matches_jax():
    """The whole `lrs_pnp` preset (2 outer iterations, 80 ISTA iterations,
    specnorm alpha, h_scale 0.1) at full width: 36x36x128, 144 blocks, the
    shipped 1296x512 dictionary."""
    D = load_trained_dictionary(512)
    s_t = synthetic_sample(36, 36, 128, seed=0)
    s_j = j_synthetic_sample(36, 36, 128, seed=0)
    j_solver = jadmm.Solver(s_j, D, jconfig.lrs_pnp_preset())
    j_state, j_hist = j_solver.run()
    t_solver = Solver(s_t, D, tconfig.lrs_pnp_preset(), device="cpu")
    t_state, t_hist = t_solver.run()
    ref = np.asarray(j_state.X)
    np.testing.assert_allclose(t_state.X.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(t_hist["mpsnr"], j_hist["mpsnr"], atol=1e-3)
    np.testing.assert_allclose(t_hist["ssim"], j_hist["ssim"], atol=1e-4)
    assert t_hist["dip_iters"] == [0.0, 0.0]
    assert t_hist["mpsnr"][-1] > t_hist["mpsnr"][0] > 33.0


def test_inpaint_lrs_pnp_small_matches_jax_pallas_interpret():
    """A small `lrs_pnp` solve through ``inpaint`` and ``solve``; the JAX
    side runs its sparse prox through the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(5)
    D = rng.standard_normal((64, 48)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    s_t = synthetic_sample(16, 16, 24, missing=0.08, seed=21)
    s_j = j_synthetic_sample(16, 16, 24, missing=0.08, seed=21)
    kw = dict(variant="lrs_pnp", outer_iters=2, block_size=8, stride=8, dip=None, mu1=0.15, mu2=0.9)
    sp = dict(n_iter=10, alpha_mode="specnorm", h_scale=0.1)
    t_cfg = tconfig.SolverConfig(sparse=tconfig.SparseProxConfig(**sp), **kw)
    j_cfg = jconfig.SolverConfig(sparse=jconfig.SparseProxConfig(backend="pallas", **sp), **kw)
    ref, j_hist = jadmm.solve(s_j, D, j_cfg)
    cube, hist = inpaint(s_t.noisy, s_t.mask, config=t_cfg, clean=s_t.clean, dictionary=D, device="cpu")
    assert cube.shape == (16, 16, 24)
    np.testing.assert_allclose(cube, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(hist["mpsnr"], j_hist["mpsnr"], atol=1e-3)
    cube2, _ = solve(s_t, D, t_cfg, device="cpu")
    np.testing.assert_array_equal(cube2, cube)  # deterministic


def test_custom_svt_fn_is_used():
    s = synthetic_sample(16, 16, 24, missing=0.08, seed=21)
    D = np.eye(64, 48, dtype=np.float32)
    cfg = tconfig.lrs_pnp_preset(block_size=8, stride=8)
    calls = []

    def svt_fn(Z, tau):
        calls.append(tau)
        return svt(Z, tau)

    solver = Solver(s, D, cfg, device="cpu", svt_fn=svt_fn)
    state, _ = solver.step(solver.init_state())
    ref, _ = Solver(s, D, cfg, device="cpu").step(solver.init_state())
    assert calls == [1.0 / cfg.mu2]
    np.testing.assert_allclose(state.X.numpy(), ref.X.numpy(), atol=1e-4)
