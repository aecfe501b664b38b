"""The port's sparse prox (plain PnP-ISTA, NLM, step sizes) against the JAX
package's XLA path and its Pallas kernel in interpret mode.

Tolerances: rtol 1e-4 / atol 1e-6, as in ``tests/test_ista_pallas.py`` —
the products sum in another order, and the kernel-form NLM multiplies by
-1/(9h^2) where the XLA form divides by 9h^2.  Kernel B1 is held to the
bf16 plain loop at max |delta| < BF16_MATCH max |ref|; the last tests show
that this limit rejects a loop that skips the rounding of any operand."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.ops import ista as jista
from lrs_pnp_dip_tpu.ops.ista_pallas import pnp_ista_blocks_pallas
from lrs_pnp_dip_tpu.ops.nlm import nlm_column_batch_fast as j_nlm
from lrs_pnp_dip_tpu_torch.data import load_trained_dictionary, synthetic_sample
from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, block_grid, extract_blocks, pnp_ista_blocks_fused
from lrs_pnp_dip_tpu_torch.ops import ista as tista
from lrs_pnp_dip_tpu_torch.ops.nlm import nlm_column_batch_fast as t_nlm
from lrs_pnp_dip_tpu_torch.solvers import make_consts
from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig, dip_preset

RTOL, ATOL = 1e-4, 1e-6
BF16_MATCH = 1e-5  # as chip_smoke.py


def _problem(seed, P=48, K=32, nB=5, missing_block=False):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((P, K)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    Y = rng.standard_normal((nB, P)).astype(np.float32)
    M = (rng.random((nB, P)) > 0.12).astype(np.float32)
    if missing_block:
        M[1] = 0.0  # alpha clamps at 1e-12
    return Y, M, D


def _jcfg(cfg):
    return jista.SparseProxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("alpha_mode", ["trace4", "specnorm"])
def test_compute_alpha_matches(alpha_mode):
    Y, M, D = _problem(0, nB=7, missing_block=True)
    cfg = SparseProxConfig(alpha_mode=alpha_mode, power_iters=30)
    ours = tista.compute_alpha(*_t(D, M), cfg).numpy()
    ref = np.asarray(jista.compute_alpha(jnp.asarray(D), jnp.asarray(M), _jcfg(cfg)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    assert ours[1] == np.float32(1e-12)


def test_nlm_matches():
    rng = np.random.default_rng(1)
    G = rng.standard_normal((6, 40)).astype(np.float32)
    h = rng.uniform(0.05, 2.0, size=6).astype(np.float32)
    ours = t_nlm(*_t(G, h)).numpy()
    ref = np.asarray(j_nlm(jnp.asarray(G), jnp.asarray(h)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize(
    "nB,alpha_mode,h_scale",
    [(5, "trace4", 1.0), (13, "trace4", 1.0), (5, "specnorm", 0.1), (13, "specnorm", 0.1)],
)
def test_plain_ista_matches_xla_and_pallas(nB, alpha_mode, h_scale):
    Y, M, D = _problem(nB, nB=nB, missing_block=True)
    cfg = SparseProxConfig(n_iter=12, alpha_mode=alpha_mode, h_scale=h_scale, power_iters=30)
    ours = tista.pnp_ista_blocks(*_t(Y, M, D), cfg).numpy()
    args = (jnp.asarray(Y), jnp.asarray(M), jnp.asarray(D), _jcfg(cfg))
    xla = np.asarray(jista.pnp_ista_blocks(*args))
    pallas = np.asarray(pnp_ista_blocks_pallas(*args, interpret=True))
    np.testing.assert_allclose(ours, xla, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, rtol=RTOL, atol=ATOL)
    assert np.all(ours[1] == 0.0)  # a fully missing block never moves


def test_plain_ista_bf16_operands_match():
    """bf16 operands, f32 accumulation: the same rounded operands on both
    sides, so the f32 tolerance still holds."""
    Y, M, D = _problem(2, nB=5)
    cfg = SparseProxConfig(n_iter=10, matmul_dtype="bfloat16")
    ours = tista.pnp_ista_blocks(*_t(Y, M, D), cfg).numpy()
    args = (jnp.asarray(Y), jnp.asarray(M), jnp.asarray(D), _jcfg(cfg))
    pallas = np.asarray(pnp_ista_blocks_pallas(*args, interpret=True))
    xla = np.asarray(jista.pnp_ista_blocks(*args))
    np.testing.assert_allclose(ours, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, xla, rtol=RTOL, atol=ATOL)
    f32 = tista.pnp_ista_blocks(*_t(Y, M, D), SparseProxConfig(n_iter=10)).numpy()
    assert 0 < np.abs(ours - f32).max() < 0.02 * np.abs(f32).max()


def test_sparse_prox_with_precomputed_alpha_matches():
    Y, M, D = _problem(3, nB=9)
    cfg = SparseProxConfig(n_iter=8)
    alpha = tista.compute_alpha(*_t(D, M), cfg)
    ours = tista.sparse_prox(*_t(Y, M, D), cfg, alpha=alpha).numpy()
    ref = np.asarray(
        jista.sparse_prox(
            jnp.asarray(Y), jnp.asarray(M), jnp.asarray(D), _jcfg(cfg),
            alpha=jnp.asarray(alpha.numpy()),
        )
    )
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=1e-5)


def test_wrapper_takes_plain_path_for_cpu_tensors():
    """sparse_prox takes the plain loop for CPU tensors; the kernel's
    wrapper takes CUDA tensors only."""
    Y, M, D = _problem(4, nB=3)
    cfg = SparseProxConfig(n_iter=5)
    before = ISTA_KERNEL.launches
    ours = tista.sparse_prox(*_t(Y, M, D), cfg)
    assert ISTA_KERNEL.launches == before
    assert torch.equal(ours, tista.pnp_ista_blocks(*_t(Y, M, D), cfg) @ torch.from_numpy(D).T)
    with pytest.raises(ValueError, match="CUDA device"):
        pnp_ista_blocks_fused(*_t(Y, M, D), cfg)
    assert ISTA_KERNEL.launches == before


def _loop_rounding(Ym, M, D, alpha, h, n_iter, rounded):
    """The plain loop with bf16 rounding of only the operands named in
    ``rounded`` (x, r for the residual, D)."""

    def rnd(t, name):
        return t.to(torch.bfloat16).float() if name in rounded else t

    Dm = rnd(D, "D")
    x = torch.zeros((Ym.shape[0], D.shape[1]))
    for _ in range(n_iter):
        resid = Ym - M * (rnd(x, "x") @ Dm.T)
        x = t_nlm(x + (rnd(resid, "r") @ Dm) / alpha[:, None], h)
    return x


@pytest.fixture(scope="module")
def main_path_blocks():
    """The first 13 blocks that the dip solve's first sparse prox gets."""
    sample = synthetic_sample(36, 36, 128, seed=0)
    cfg = dip_preset()
    consts = make_consts(sample, load_trained_dictionary(512), cfg, device="cpu")
    blocks = extract_blocks(consts.Y, block_grid((36 * 36, 128), cfg.block_size, cfg.stride))
    return blocks[:13], consts.mask_blocks[:13], consts.D, consts.alpha[:13]


@pytest.mark.parametrize("rounded", ["", "x", "r", "D", "xr", "xD", "rD", "xrD"])
def test_bf16_match_rejects_unrounded_operands(main_path_blocks, rounded):
    """A loop that rounds every operand matches the bf16 plain loop; one
    that skips any rounding (f32 is "") fails the bf16 match."""
    cfg = SparseProxConfig(n_iter=100, matmul_dtype="bfloat16")
    blocks, masks, D, alpha = main_path_blocks
    ref = tista.pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha)
    Ym, M, D, alpha, h = tista._prepare(blocks, masks, D, cfg, alpha)
    got = _loop_rounding(Ym, M, D, alpha, h, cfg.n_iter, rounded)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if rounded == "xrD":
        assert err < BF16_MATCH * scale
    else:
        assert err >= BF16_MATCH * scale


@pytest.mark.parametrize("denoiser", ["nlm_classic", "bm3d"])
def test_unported_denoisers_raise(denoiser):
    Y, M, D = _problem(5, nB=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tista.sparse_prox(*_t(Y, M, D), SparseProxConfig(n_iter=2, denoiser=denoiser))
