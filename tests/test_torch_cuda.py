"""Kernel B1 on the card, against its plain PyTorch version.

These need an NVIDIA GPU (sm_90a) and ``nvcc``; without a card they skip.
This file imports nothing of JAX, so on the machine with the card it runs
without the repository's ``conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 rtol 1e-4 / atol 1e-5 (the kernel sums the products in
another order than cuBLAS and multiplies by -1/(9h^2) where the plain NLM
divides by 9h^2); bf16 operands against the bf16 plain loop max |delta| <
1e-5 max|ref| (the same rounding, in another order), and against the f32
plain loop max |delta| < 0.02 max|ref|, as in ``tests/test_ista_pallas.py``.
"""

import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, pnp_ista_blocks, pnp_ista_blocks_fused
from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(cuda, nB, P, K, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((P, K)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    Y = rng.standard_normal((nB, P)).astype(np.float32)
    M = (rng.random((nB, P)) > 0.12).astype(np.float32)
    M[min(1, nB - 1)] = 0.0  # a fully missing block
    return [torch.from_numpy(a).to(cuda) for a in (Y, M, D)]


@pytest.mark.parametrize("nB", [1, 5, 8, 13, 40])
@pytest.mark.parametrize("alpha_mode", ["trace4", "specnorm"])
def test_kernel_matches_plain_f32(cuda, nB, alpha_mode):
    Y, M, D = _problem(cuda, nB, P=48, K=32, seed=nB)
    cfg = SparseProxConfig(n_iter=15, alpha_mode=alpha_mode, h_scale=0.1 if alpha_mode == "specnorm" else 1.0)
    before = ISTA_KERNEL.launches
    got = pnp_ista_blocks_fused(Y, M, D, cfg)
    torch.cuda.synchronize()
    assert ISTA_KERNEL.launches == before + 1
    ref = pnp_ista_blocks(Y, M, D, cfg)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("K", [32, 300, 512, 600])
def test_kernel_matches_plain_odd_widths(cuda, K):
    """K past one pass of the column loops, and P not a multiple of 32."""
    Y, M, D = _problem(cuda, 11, P=1300 if K >= 512 else 100, K=K, seed=K)
    cfg = SparseProxConfig(n_iter=6)
    got = pnp_ista_blocks_fused(Y, M, D, cfg)
    torch.testing.assert_close(got, pnp_ista_blocks(Y, M, D, cfg), rtol=1e-4, atol=1e-5)


def test_kernel_bf16_operands_track_plain(cuda):
    Y, M, D = _problem(cuda, 13, P=48, K=32, seed=2)
    cfg = SparseProxConfig(n_iter=10, matmul_dtype="bfloat16")
    got = pnp_ista_blocks_fused(Y, M, D, cfg)
    ref = pnp_ista_blocks(Y, M, D, cfg)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) < 1e-5 * float(ref.abs().max())
    f32 = pnp_ista_blocks(Y, M, D, SparseProxConfig(n_iter=10))
    assert float((got - f32).abs().max()) < 0.02 * float(f32.abs().max())


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    Y, M, D = _problem(cuda, 4, P=48, K=32)
    cfg = SparseProxConfig(n_iter=2)
    with pytest.raises(ValueError, match="contiguous"):
        pnp_ista_blocks_fused(Y, M, D.T.contiguous().T, cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        pnp_ista_blocks_fused(Y, M, D.cpu(), cfg)
    with pytest.raises(ValueError, match="shape"):
        pnp_ista_blocks_fused(Y, M[:, :40].contiguous(), D, cfg)
