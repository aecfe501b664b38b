"""The port's MATLAB twin against the JAX package: the NLM denoisers
(``nlm2d``, ``nlm_column``, ``nlm_classic`` and its 1-D collapse), the
twin's SSIM, its masks and sample, the sparse prox with ``nlm_classic`` and
the `matlab` preset solve.

Tolerances: the NLMs within rtol 1e-5 / atol 1e-6 (they sum the patch
distances in another order), the port's classic NLM run with subnormal floats
flushed to zero, as XLA's CPU backend runs the JAX package: a pixel whose
weights all lie below the smallest normal float (d / h^2 between 87.3 and
103.3) gets 0 or its input there and a weighted average in PyTorch, which
keeps subnormals (``test_nlm_classic_differs_only_by_subnormal_flushing``);
``ssim_matlab`` within 1e-6; the masks and the sample bit-equal (the same
numpy code); the sparse prox within rtol 1e-4 /
atol 1e-6 as in ``tests/test_torch_ista.py``; the `matlab` preset solve,
cut as ``tests/test_matlab_twin.py`` cuts it, within 1e-4 of max |X|, the
limit of the `lrs_pnp` solve (``tests/test_torch_svt.py``)."""

import contextlib
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.data import random_dictionary
from lrs_pnp_dip_tpu.data import masks as jmasks
from lrs_pnp_dip_tpu.ops import ista as jista
from lrs_pnp_dip_tpu.solvers import Solver as JSolver
from lrs_pnp_dip_tpu.utils import config as jconfig
from lrs_pnp_dip_tpu_torch import inpaint
from lrs_pnp_dip_tpu_torch.data import masks as tmasks
from lrs_pnp_dip_tpu_torch.ops import ista as tista
from lrs_pnp_dip_tpu_torch.ops import nlm as tnlm
from lrs_pnp_dip_tpu_torch.ops import ssim_matlab
from lrs_pnp_dip_tpu_torch.utils import config as tconfig

# the JAX package's ops/__init__ binds the name `ssim` to the function
jnlm = importlib.import_module("lrs_pnp_dip_tpu.ops.nlm")
jssim = importlib.import_module("lrs_pnp_dip_tpu.ops.ssim")

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

NLM_TOL = dict(rtol=1e-5, atol=1e-6)


@contextlib.contextmanager
def flushed_subnormals():
    """Run PyTorch's CPU arithmetic with subnormals flushed to zero, as XLA's
    CPU backend runs the JAX package."""
    assert torch.set_flush_denormal(True), "this CPU cannot flush subnormals"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


@pytest.mark.parametrize("mode", ["reflect", "symmetric"])
@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_pad_index_is_np_pad(n, mode):
    for pad in (1, 3, 5, 9):
        got = tnlm.np_pad_index(n, pad, mode, "cpu").numpy()
        np.testing.assert_array_equal(got, np.pad(np.arange(n), pad, mode=mode))


@pytest.mark.parametrize("shape", [(9, 7), (12, 1)], ids=["9x7", "column"])
def test_nlm2d_matches(shape):
    rng = np.random.default_rng(0)
    img = rng.random(shape).astype(np.float32)
    for h in (0.05, 0.3, 2.0):
        ref = np.asarray(jnlm.nlm2d(jnp.asarray(img), h))
        np.testing.assert_allclose(tnlm.nlm2d(torch.from_numpy(img), h).numpy(), ref, **NLM_TOL)


def test_nlm_column_and_batch_match():
    rng = np.random.default_rng(1)
    G = rng.standard_normal((5, 40)).astype(np.float32)
    h = rng.uniform(0.05, 1.0, 5).astype(np.float32)
    ref = np.asarray(jnlm.nlm_column_batch(jnp.asarray(G), jnp.asarray(h)))
    got = tnlm.nlm_column_batch(torch.from_numpy(G), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, ref, **NLM_TOL)
    one = tnlm.nlm_column(torch.from_numpy(G[2]), float(h[2])).numpy()
    np.testing.assert_allclose(one, np.asarray(jnlm.nlm_column(jnp.asarray(G[2]), h[2])), **NLM_TOL)
    # and the fast 1-D collapse is the same filter
    fast = tnlm.nlm_column_batch_fast(torch.from_numpy(G), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(fast, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(10, 8), (5, 3), (16, 1)], ids=["10x8", "5x3", "column"])
def test_nlm_classic_matches(shape):
    """The general 2-D NLM, one image and a batch with an h per image (the
    5x3 image is narrower than the search window)."""
    rng = np.random.default_rng(2)
    imgs = rng.random((3,) + shape).astype(np.float32)
    hs = np.array([0.02, 0.2, 1.5], np.float32)
    with flushed_subnormals():
        got = tnlm.nlm_classic(torch.from_numpy(imgs), torch.from_numpy(hs)).numpy()
        ones = [tnlm.nlm_classic(torch.from_numpy(imgs[i]), float(hs[i])).numpy() for i in range(3)]
    for i in range(3):
        ref = np.asarray(jnlm.nlm_classic(jnp.asarray(imgs[i]), hs[i]))
        np.testing.assert_allclose(got[i], ref, **NLM_TOL)
        np.testing.assert_allclose(ones[i], ref, **NLM_TOL)


def test_nlm_classic_column_collapse_matches_the_general_2d_filter():
    """``nlm_classic_column_batch`` (6 shifts, 7 taps) against the general
    2-D ``nlm_classic`` of (K, 1) images in both packages, at bandwidths
    from all weights underflowing (the filter returns its input) to smooth."""
    rng = np.random.default_rng(3)
    G = (0.3 * rng.standard_normal((6, 64))).astype(np.float32)
    h = np.array([1e-4, 0.01, 0.05, 0.2, 1.0, 5.0], np.float32)
    with flushed_subnormals():
        got = tnlm.nlm_classic_column_batch(torch.from_numpy(G), torch.from_numpy(h)).numpy()
        general = tnlm.nlm_classic(torch.from_numpy(G[:, :, None]), torch.from_numpy(h)).numpy()[:, :, 0]
    ref = np.stack([np.asarray(jnlm.nlm_classic(jnp.asarray(g[:, None]), hh))[:, 0] for g, hh in zip(G, h)])
    np.testing.assert_allclose(got, ref, **NLM_TOL)
    np.testing.assert_allclose(general, ref, **NLM_TOL)
    np.testing.assert_array_equal(got[0], G[0])  # h 1e-4: every weight is 0
    # the collapse equals the general filter with subnormals kept too
    kept = tnlm.nlm_classic_column_batch(torch.from_numpy(G), torch.from_numpy(h)).numpy()
    kept_general = tnlm.nlm_classic(torch.from_numpy(G[:, :, None]), torch.from_numpy(h)).numpy()[:, :, 0]
    np.testing.assert_allclose(kept, kept_general, **NLM_TOL)


def test_nlm_classic_differs_only_by_subnormal_flushing():
    """Row 2 of the collapse test's input (h 0.05) has pixels whose every
    weight is subnormal (exp(-87.6) and below).  Flushed, as XLA computes,
    their output is 0 (the weighted sum flushes) or the input pixel; kept,
    as PyTorch computes and as MATLAB's doubles would, it is the weighted
    average.  Only those pixels differ."""
    rng = np.random.default_rng(3)
    G = torch.from_numpy((0.3 * rng.standard_normal((6, 64))).astype(np.float32)[2:3])
    h = torch.tensor([0.05])
    kept = tnlm.nlm_classic_column_batch(G, h)
    with flushed_subnormals():
        flushed = tnlm.nlm_classic_column_batch(G, h)
    ref = np.asarray(jnlm.nlm_classic(jnp.asarray(G[0, :, None].numpy()), 0.05))[:, 0]
    np.testing.assert_allclose(flushed[0].numpy(), ref, **NLM_TOL)
    moved = (kept - flushed).abs()[0] > 1e-3
    assert 0 < int(moved.sum()) <= 4 and float(flushed[0, 13]) == 0.0
    np.testing.assert_allclose(kept[0, ~moved].numpy(), ref[~moved.numpy()], **NLM_TOL)


@pytest.mark.parametrize("channels", [1, 3, 5])
def test_ssim_matlab_matches(channels):
    rng = np.random.default_rng(4)
    a = (255 * rng.random((24, 20, channels))).astype(np.float32)
    b = np.clip(a + 20 * rng.standard_normal(a.shape), 0, 255).astype(np.float32)
    if channels == 1:
        a, b = a[..., 0], b[..., 0]
    for border in ((0, 0), (3, 2)):
        ref = float(jssim.ssim_matlab(jnp.asarray(a), jnp.asarray(b), border=border))
        got = float(ssim_matlab(torch.from_numpy(a), torch.from_numpy(b), border=border))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_matlab_masks_and_sample_equal_jax():
    assert tmasks.MATLAB_STRIPS == jmasks.MATLAB_STRIPS
    np.testing.assert_array_equal(tmasks.matlab_strip_mask(), jmasks.matlab_strip_mask())
    assert int((tmasks.matlab_strip_mask() == 0).sum()) == 66
    strips = ((0, 2, 1, 3), (4, 5, 0, 6))
    np.testing.assert_array_equal(tmasks.strip_mask((6, 7), strips), jmasks.strip_mask((6, 7), strips))
    ours, ref = tmasks.matlab_twin_sample(seed=1, bands=16), jmasks.matlab_twin_sample(seed=1, bands=16)
    for field in ("noisy", "mask", "clean"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field))
    np.testing.assert_array_equal(tmasks.text_mask((12, 40), "hi"), jmasks.text_mask((12, 40), "hi"))


def test_sparse_prox_with_nlm_classic_matches_jax():
    """The `matlab` preset's sparse settings (specnorm alpha, h_scale 0.1),
    20 iterations, a block with every pixel missing among them."""
    rng = np.random.default_rng(5)
    D = rng.standard_normal((48, 32)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    Y = rng.standard_normal((6, 48)).astype(np.float32)
    M = (rng.random((6, 48)) > 0.12).astype(np.float32)
    M[2] = 0.0
    for h_scale in (0.1, 10.0):  # the preset's, and one where the NLM smooths
        cfg = tconfig.SparseProxConfig(
            n_iter=20, alpha_mode="specnorm", h_scale=h_scale, denoiser="nlm_classic", power_iters=30
        )
        jcfg = jista.SparseProxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        got = tista.sparse_prox(*map(torch.from_numpy, (Y, M, D)), cfg).numpy()
        ref = np.asarray(jista.sparse_prox(jnp.asarray(Y), jnp.asarray(M), jnp.asarray(D), jcfg))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_matlab_preset_solve_matches_jax():
    """The `matlab` preset cut as ``tests/test_matlab_twin.py`` cuts it: 64
    bands, 3 of 13 outer steps, 12 of 80 ISTA iterations, a random 1296x128
    dictionary.  X within 1e-4 of max |X|, MPSNR within 1e-3 dB at every
    step; the twin inpaints (MPSNR 0.5 dB over the input)."""
    sample = tmasks.matlab_twin_sample(seed=0, bands=64)
    j_sample = jmasks.matlab_twin_sample(seed=0, bands=64)
    D = np.asarray(random_dictionary(36 * 36, 128, seed=0), np.float32)
    t_cfg = tconfig.matlab_preset(outer_iters=3)
    t_cfg = dataclasses.replace(t_cfg, sparse=dataclasses.replace(t_cfg.sparse, n_iter=12))
    j_cfg = jconfig.matlab_preset(outer_iters=3)
    j_cfg = dataclasses.replace(j_cfg, sparse=dataclasses.replace(j_cfg.sparse, n_iter=12))

    cube, hist = inpaint(sample.noisy, sample.mask, clean=sample.clean, dictionary=D,
                         config=t_cfg, device="cpu")
    j_solver = JSolver(j_sample, D, j_cfg)
    j_state, j_hist = j_solver.run()
    ref = np.asarray(j_state.X).reshape(cube.shape)
    err = np.abs(cube - ref).max() / np.abs(ref).max()
    print(f"matlab preset, port vs JAX: {err:.3e} of max|X|; mpsnr {hist['mpsnr']} vs {j_hist['mpsnr']}")
    assert err <= 1e-4
    np.testing.assert_allclose(hist["mpsnr"], j_hist["mpsnr"], atol=1e-3)
    from lrs_pnp_dip_tpu_torch.ops import mpsnr

    inp = float(mpsnr(torch.from_numpy(sample.clean), torch.from_numpy(sample.noisy)))
    assert hist["best_mpsnr"] > inp + 0.5
