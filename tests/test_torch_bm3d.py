"""The port's BM3D and proximal library against the JAX package.

BM3D's hard threshold ``|c| >= lambda3d * sigma`` and its block matching
(the ``group`` nearest patches) are discontinuous in the input, so the
inputs here are random images with no two candidate distances within
rounding of each other and no coefficient within rounding of the threshold
(``_assert_tie_free`` checks the single images for both): on such inputs the group indices are
equal and the outputs agree within rtol 1e-5 / atol 1e-5 (the transforms and
the aggregation sum in another order).  Exact ties are pinned separately:
the port takes the lower index first, as ``jax.lax.top_k`` does.  The sparse
prox with the ``bm3d`` denoiser agrees within rtol 1e-4 / atol 1e-6 as in
``tests/test_torch_ista.py``; the proxlib functions within 1e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.ops import ista as jista
from lrs_pnp_dip_tpu.ops import proxlib as jprox
from lrs_pnp_dip_tpu_torch.ops import ista as tista
from lrs_pnp_dip_tpu_torch.ops import proxlib as tprox
from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

# both packages' ops/__init__ bind the name `bm3d` to the function
jbm3d = importlib.import_module("lrs_pnp_dip_tpu.ops.bm3d")
tbm3d = importlib.import_module("lrs_pnp_dip_tpu_torch.ops.bm3d")

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
COEF = dict(patch=4, stride=2, group=8, search=8, wiener=False)  # the ISTA denoiser's profile


def _cfgs(**kw):
    return jbm3d.Bm3dConfig(**kw), tbm3d.Bm3dConfig(**kw)


def _assert_tie_free(img, cfg, sigma=None):
    """No two candidate distances of a patch within 1e-5 of each other at
    the group boundary, none within 1e-5 of the match cutoff, and no 3-D
    coefficient within 1e-5 of the hard threshold at ``sigma`` (float64 on
    the host; f32 rounding moves these values by about 1e-7)."""
    geo = tbm3d._Geometry(*img.shape, cfg, "cpu")
    patches = img.astype(np.float64).reshape(-1)[geo.pix.numpy()]
    flat = patches.reshape(geo.nP, -1)
    d2 = ((flat[:, None, :] - flat[None, :, :]) ** 2).sum(-1)
    d2 = np.where(geo.near.numpy(), d2, np.inf)
    g = min(cfg.group, geo.nP)
    srt = np.sort(d2, axis=1)
    finite = np.isfinite(srt[:, g])
    assert (np.abs(srt[finite, g] - srt[finite, g - 1]) > 1e-5).all(), "a near-tie at the group boundary"
    assert (np.abs(srt[:, :g] - cfg.tau_match * flat.shape[1]) > 1e-5).all(), "a distance at the cutoff"
    if sigma is None:
        return
    idx = np.argsort(d2, axis=1, kind="stable")[:, :g]
    C = tbm3d._dct_matrix(geo.p).astype(np.float64)
    coef = np.einsum("ij,njk,lk->nil", C, patches, C)
    Tg = tbm3d._dct_matrix(g).astype(np.float64)
    c3 = np.einsum("gh,nhpq->ngpq", Tg, coef[idx])
    assert (np.abs(np.abs(c3) - cfg.lambda3d * sigma) > 1e-5).all(), "a coefficient at the threshold"


def test_group_indices_equal_on_tie_free_input():
    rng = np.random.default_rng(0)
    img = rng.random((20, 18)).astype(np.float32)
    jcfg, tcfg = _cfgs(patch=4, stride=2, group=8, search=6)
    _assert_tie_free(img, tcfg)
    geo = tbm3d._Geometry(20, 18, tcfg, "cpu")
    j_patches, py, px = jbm3d._extract(jnp.asarray(img), jbm3d._grid(20, 4, 2), jbm3d._grid(18, 4, 2), 4)
    ref = np.asarray(jbm3d._match(j_patches, py, px, jcfg, jcfg.tau_match))
    got = tbm3d._match(geo.extract(torch.from_numpy(img)[None]), geo, tcfg, tcfg.tau_match)[0]
    np.testing.assert_array_equal(got.numpy(), ref)


def test_exact_ties_take_the_lower_index_first():
    """A constant image: every distance within the radius is exactly 0, and
    both packages take the group in index order."""
    img = np.full((16, 16), 0.25, np.float32)
    jcfg, tcfg = _cfgs(patch=4, stride=2, group=8, search=4)
    geo = tbm3d._Geometry(16, 16, tcfg, "cpu")
    j_patches, py, px = jbm3d._extract(jnp.asarray(img), jbm3d._grid(16, 4, 2), jbm3d._grid(16, 4, 2), 4)
    ref = np.asarray(jbm3d._match(j_patches, py, px, jcfg, jcfg.tau_match))
    got = tbm3d._match(geo.extract(torch.from_numpy(img)[None]), geo, tcfg, tcfg.tau_match)[0].numpy()
    np.testing.assert_array_equal(got, ref)
    near = np.flatnonzero(geo.near.numpy()[0])
    np.testing.assert_array_equal(got[0], near[:8])


@pytest.mark.parametrize("wiener", [False, True], ids=["hard", "wiener"])
def test_bm3d_matches(wiener):
    rng = np.random.default_rng(1)
    clean = np.outer(np.sin(np.linspace(0, 3, 24)), np.cos(np.linspace(0, 2, 24)))
    img = (0.5 + 0.3 * clean + 0.1 * rng.standard_normal((24, 24))).astype(np.float32)
    jcfg, tcfg = _cfgs(patch=4, stride=2, group=8, search=6, wiener=wiener)
    _assert_tie_free(img, tcfg, 0.1)
    ref = np.asarray(jbm3d.bm3d(jnp.asarray(img), 0.1, jcfg))
    got = tbm3d.bm3d(torch.from_numpy(img), 0.1, tcfg).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(got - img).max() > 1e-3  # it did filter


def test_bm3d_batch_prox_and_coefficient_denoiser_match():
    """A batch with one sigma per image, the prox over the bands of a cube
    (default profile, both stages) and the ISTA coefficient denoiser."""
    rng = np.random.default_rng(3)
    imgs = rng.random((3, 16, 12)).astype(np.float32)
    sig = np.array([0.05, 0.1, 0.2], np.float32)
    jcfg, tcfg = _cfgs(**COEF)
    for im, s in zip(imgs, sig):
        _assert_tie_free(im, tcfg, s)
    got = tbm3d.bm3d(torch.from_numpy(imgs), torch.from_numpy(sig), tcfg).numpy()
    for i in range(3):
        np.testing.assert_allclose(got[i], np.asarray(jbm3d.bm3d(jnp.asarray(imgs[i]), sig[i], jcfg)), **TOL)

    cube = rng.random((20, 20, 3)).astype(np.float32)
    ref = np.asarray(jprox.bm3d_prox(jnp.asarray(cube), 0.1))
    np.testing.assert_allclose(tprox.bm3d_prox(torch.from_numpy(cube), 0.1).numpy(), ref, **TOL)
    with pytest.raises(ValueError, match="bm3d_prox expects"):
        tbm3d.bm3d_prox(torch.zeros(4), 0.1)

    G = rng.standard_normal((4, 64)).astype(np.float32)
    h = np.array([0.1, 0.3, 0.6, 1.0], np.float32)
    ref = np.asarray(jbm3d.bm3d_coef_batch(jnp.asarray(G), jnp.asarray(h), jcfg))
    got = tbm3d.bm3d_coef_batch(torch.from_numpy(G), torch.from_numpy(h), tcfg).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_sparse_prox_with_bm3d_matches_jax():
    """The ISTA with the bm3d denoiser (K 64, folded to 8x8 images), 3
    iterations; the fused wrapper refuses the denoiser."""
    rng = np.random.default_rng(3)
    D = rng.standard_normal((48, 64)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    Y = rng.standard_normal((4, 48)).astype(np.float32)
    M = (rng.random((4, 48)) > 0.12).astype(np.float32)
    cfg = SparseProxConfig(n_iter=3, denoiser="bm3d", lambda_ista=2.0)
    jcfg = jista.SparseProxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    got = tista.sparse_prox(*map(torch.from_numpy, (Y, M, D)), cfg).numpy()
    ref = np.asarray(jista.sparse_prox(jnp.asarray(Y), jnp.asarray(M), jnp.asarray(D), jcfg))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="nlm_fast denoiser only"):
        tista.pnp_ista_blocks_fused(*map(torch.from_numpy, (Y, M, D)), cfg)


def test_measurement_operators():
    gen = torch.Generator().manual_seed(0)
    op = tprox.inpainting_operator(gen, (6, 7), 0.6)
    x = torch.rand((6, 7), generator=gen)
    assert set(op.diag.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(op.A(x), op.diag * x) and torch.equal(op.At(x), op.diag * x)
    again = tprox.inpainting_operator(torch.Generator().manual_seed(0), (6, 7), 0.6)
    assert torch.equal(again.diag, op.diag)
    j_op = jprox.superresolution_operator((7, 9), 3)
    t_op = tprox.superresolution_operator((7, 9), 3, device="cpu")
    np.testing.assert_array_equal(t_op.diag.numpy(), np.asarray(j_op.diag))
    xs = np.random.default_rng(4).random((7, 9)).astype(np.float32)
    np.testing.assert_array_equal(t_op.A(torch.from_numpy(xs)).numpy(), np.asarray(j_op.A(jnp.asarray(xs))))


def test_proxes_and_projections_match():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((10, 9)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    pairs = [
        (tprox.l1_prox(xt, 0.3), jprox.l1_prox(xj, 0.3)),
        (tprox.tv_prox(xt, 0.2, n_iter=30), jprox.tv_prox(xj, 0.2, n_iter=30)),
        (tprox.nlm_prox(xt, 0.5), jprox.nlm_prox(xj, 0.5)),
        (tprox.linf_project(xt, 0.5), jprox.linf_project(xj, 0.5)),
        (tprox.simplex_project(xt, 2.0), jprox.simplex_project(xj, 2.0)),
        (tprox.l1_project(xt, 3.0), jprox.l1_project(xj, 3.0)),
        (tprox.l1_project(xt * 0.01, 3.0), jprox.l1_project(xj * 0.01, 3.0)),  # inside the ball
        (tprox.linf_prox(xt, 0.4), jprox.linf_prox(xj, 0.4)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    s = tprox.simplex_project(xt, 2.0)
    assert float(s.min()) >= 0 and abs(float(s.sum()) - 2.0) < 1e-5


def _aggregate_index_add(filtered, weights, idx, geo, shape):
    """The aggregation as it was: ``index_add_`` over group membership, then
    onto the pixel grid."""
    N, nP, g = idx.shape
    p2 = geo.p * geo.p
    seg = (idx + nP * torch.arange(N)[:, None, None]).reshape(-1)
    vals = (filtered * weights[:, :, None, None, None]).reshape(N * nP * g, p2)
    wrep = weights[:, :, None].expand(N, nP, g).reshape(-1)
    patch_num = torch.zeros((N * nP, p2)).index_add_(0, seg, vals)
    patch_den = torch.zeros(N * nP).index_add_(0, seg, wrep)
    pix = geo.pix.reshape(-1)
    H, W = shape
    num = torch.zeros((N, H * W)).index_add_(1, pix, patch_num.reshape(N, -1))
    den = torch.zeros((N, H * W)).index_add_(1, pix, patch_den.reshape(N, nP, 1).expand(N, nP, p2).reshape(N, -1))
    return num.reshape(N, H, W), den.reshape(N, H, W)


@pytest.mark.parametrize(
    "H,W,cfg",
    [(20, 17, tbm3d.Bm3dConfig()), (32, 16, tbm3d.Bm3dConfig(**COEF)), (5, 9, tbm3d.Bm3dConfig())],
    ids=["default-ragged-grid", "coef-profile", "patch-clipped"],
)
def test_aggregation_matches_the_index_add_sums(H, W, cfg):
    """The fixed-order aggregation (member sums by passes over a stable
    sort, pixel sums by passes over the patch entries) against the
    index_add_ sums it replaces, on random groups that repeat members (as
    the tau cut makes them): on the CPU both add in index order, so the
    bits are equal."""
    rng = np.random.default_rng(H * W)
    geo = tbm3d._Geometry(H, W, cfg, "cpu")
    N, g, p = 3, min(cfg.group, geo.nP), geo.p
    idx = torch.from_numpy(rng.integers(0, geo.nP, (N, geo.nP, g)))
    idx[:, :, 0] = torch.arange(geo.nP)
    filtered = torch.from_numpy(rng.standard_normal((N, geo.nP, g, p, p)).astype(np.float32))
    weights = torch.from_numpy(rng.uniform(0.1, 1.0, (N, geo.nP)).astype(np.float32))
    num, den = tbm3d._aggregate(filtered, weights, idx, geo, (H, W))
    ref_num, ref_den = _aggregate_index_add(filtered, weights, idx, geo, (H, W))
    assert torch.equal(num, ref_num) and torch.equal(den, ref_den)


@pytest.mark.parametrize("N,L,F,n_seg", [(3, 200, 5, 17), (2, 4000, 65, 250), (1, 10, 3, 40)],
                         ids=["dense", "bm3d-width", "empty-segments"])
def test_segment_sum_adds_in_index_order(N, L, F, n_seg):
    """``_segment_sum`` equals ``index_add_`` on the CPU bit for bit: each
    segment's rows are added one at a time in their order, including
    segments that no row reaches."""
    rng = np.random.default_rng(L)
    seg = torch.from_numpy(rng.integers(0, n_seg, (N, L)))
    vals = torch.from_numpy(rng.standard_normal((N, L, F)).astype(np.float32))
    got = tbm3d._segment_sum(vals, seg, n_seg)
    flat = (seg + n_seg * torch.arange(N)[:, None]).reshape(-1)
    ref = torch.zeros(N * n_seg, F).index_add_(0, flat, vals.reshape(N * L, F)).reshape(N, n_seg, F)
    assert torch.equal(got, ref)
