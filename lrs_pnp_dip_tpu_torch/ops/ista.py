"""Patch-wise dictionary sparse coding via plug-and-play ISTA (counterpart of
``lrs_pnp_dip_tpu/ops/ista.py``).

Masked ISTA: for ``H = D[kept_rows]`` the pruned-row gradient equals
``x + D^T (m * (y - D x)) / alpha``, so every block runs with static shapes:

    gradient = x + D^T (m * (y - D x)) / alpha
    x        = NLM(gradient, h = h_scale * lambda / (2 alpha))

and the reconstruction uses the full dictionary, ``Phi_z = x D^T``.

:func:`pnp_ista_blocks` is the plain PyTorch loop, with any of the three
denoisers: ``nlm_fast`` (skimage's fast-mode NLM, the Python reference's),
``nlm_classic`` (the MATLAB twin's NLM) and ``bm3d``.
:func:`pnp_ista_blocks_fused` is the loop through kernel B1 (``csrc/ista.cu``,
CUDA tensors and ``nlm_fast`` only).  :func:`sparse_prox` launches the kernel
when :func:`use_kernel` says so: the tensors are on the card, the denoiser is
``nlm_fast`` and ``backend`` is not ``"xla"``; it runs the plain loop
otherwise, on whatever device the tensors are.  The JAX package likewise runs
its Pallas kernel for ``nlm_fast`` only, and its scan for ``backend="xla"``
(``lrs_pnp_dip_tpu/ops/ista.py:_use_pallas``).  A shape the kernel's plan
refuses raises the plan's ``ValueError``, which names ``backend="xla"``.

``group`` (a process group) splits the pixel rows of the blocks and of the
dictionary over its ranks: every partial product against D is summed over
the group with one ``all_reduce``, the counterpart of the JAX body's
``axis_name`` / ``_psum``.  Without a group the hook is the identity, and the
loop is the unsharded one, bit for bit.
"""

from __future__ import annotations

import torch

from ..utils.comm import all_reduce
from ..utils.config import SparseProxConfig
from .bm3d import Bm3dConfig, bm3d_coef_batch
from .ista_cuda import ISTA_KERNEL
from .nlm import nlm_classic_column_batch, nlm_column_batch_fast

# The BM3D profile of the coefficient denoiser (``lrs_pnp_dip_tpu/ops/ista.py:175``).
_BM3D_COEF = Bm3dConfig(patch=4, stride=2, group=8, search=8, wiener=False)


def _denoiser(cfg: SparseProxConfig, h: torch.Tensor):
    """The PnP denoiser of the loop, ``grad (nB, K) -> x (nB, K)`` with the
    per-block bandwidth ``h`` (nB,)."""
    if cfg.denoiser == "nlm_fast":
        return lambda g: nlm_column_batch_fast(g, h)
    if cfg.denoiser == "nlm_classic":
        return lambda g: nlm_classic_column_batch(g, h)
    if cfg.denoiser == "bm3d":
        return lambda g: bm3d_coef_batch(g, h, _BM3D_COEF)
    raise ValueError(f"unknown denoiser {cfg.denoiser!r}")


def _alpha_trace4(D: torch.Tensor, M: torch.Tensor, group=None) -> torch.Tensor:
    """alpha_j = 4 * sum_r m_jr ||D[r,:]||^2  — per block (nB,)."""
    row_normsq = torch.sum(D * D, dim=1)  # (P,) or this rank's (P_local,)
    return 4.0 * all_reduce(M @ row_normsq, group)


def _alpha_specnorm(D: torch.Tensor, M: torch.Tensor, n_steps: int, group=None) -> torch.Tensor:
    """alpha_j = lambda_max(D^T diag(m_j) D) via batched power iteration."""
    nB = M.shape[0]
    K = D.shape[1]
    v = torch.ones((nB, K), dtype=D.dtype, device=D.device) / (K ** 0.5)
    for _ in range(n_steps):
        u = all_reduce((M * (v @ D.T)) @ D, group)
        v = u / (torch.linalg.norm(u, dim=1, keepdim=True) + 1e-30)
    u = all_reduce((M * (v @ D.T)) @ D, group)
    return torch.sum(v * u, dim=1)  # Rayleigh quotient (v unit-norm)


def compute_alpha(
    D: torch.Tensor, mask_blocks: torch.Tensor, cfg: SparseProxConfig, group=None
) -> torch.Tensor:
    """Per-block ISTA step sizes (nB,) for the configured ``alpha_mode``,
    clamped at 1e-12 (a fully missing block gets the clamp)."""
    M = mask_blocks.to(torch.float32)
    D = D.to(torch.float32)
    if cfg.alpha_mode == "trace4":
        alpha = _alpha_trace4(D, M, group)
    elif cfg.alpha_mode == "specnorm":
        alpha = _alpha_specnorm(D, M, cfg.power_iters, group)
    else:
        raise ValueError(cfg.alpha_mode)
    return torch.clamp(alpha, min=1e-12)


def _round_operand(t: torch.Tensor, matmul_dtype: str) -> torch.Tensor:
    """The value a matrix-product operand takes: itself in f32, or rounded
    to bf16 and held in f32.  A product of two bf16 values is exact in f32,
    so an f32 product of rounded operands is a bf16-operand product with
    f32 accumulation."""
    if matmul_dtype == "float32":
        return t
    if matmul_dtype == "bfloat16":
        return t.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown matmul_dtype {matmul_dtype!r}")


def _prepare(blocks, mask_blocks, D, cfg: SparseProxConfig, alpha, group=None):
    """The loop's inputs in f32: (Ym = M * Y, M, D, alpha, per-block NLM h)."""
    Y = blocks.to(torch.float32)
    M = mask_blocks.to(torch.float32)
    D = D.to(torch.float32)
    if alpha is None:
        alpha = compute_alpha(D, M, cfg, group)
    else:
        alpha = torch.clamp(alpha.to(torch.float32), min=1e-12)
    h = cfg.h_scale * cfg.lambda_ista / (2.0 * alpha)
    return M * Y, M, D, alpha, h


def pnp_ista_blocks(
    blocks: torch.Tensor,  # (nB, P) target blocks (of X + lambda_1/mu_1)
    mask_blocks: torch.Tensor,  # (nB, P) 1 = observed entry
    D: torch.Tensor,  # (P, K) dictionary
    cfg: SparseProxConfig = SparseProxConfig(),
    alpha=None,  # optional precomputed per-block step sizes (nB,)
    group=None,  # process group over which the pixel rows are split
) -> torch.Tensor:
    """Masked PnP-ISTA on every block from x0 = 0, plain PyTorch; returns
    the coefficients (nB, K).  This is the plain version of kernel B1.
    With ``group``, ``blocks`` / ``mask_blocks`` hold this rank's pixel
    columns and ``D`` the same rows: one ``all_reduce`` of the (nB, K)
    partial gradient per iteration, and the coefficients come out equal on
    every rank of the group."""
    Ym, M, D, alpha, h = _prepare(blocks, mask_blocks, D, cfg, alpha, group)
    denoise = _denoiser(cfg, h)
    Dm = _round_operand(D, cfg.matmul_dtype)
    x = torch.zeros((Ym.shape[0], D.shape[1]), dtype=torch.float32, device=Ym.device)
    for _ in range(cfg.n_iter):
        pred = _round_operand(x, cfg.matmul_dtype) @ Dm.T  # (nB, P)
        resid = Ym - M * pred
        grad = x + all_reduce(_round_operand(resid, cfg.matmul_dtype) @ Dm, group) / alpha[:, None]
        x = denoise(grad)
    return x


def pnp_ista_blocks_fused(
    blocks: torch.Tensor,
    mask_blocks: torch.Tensor,
    D: torch.Tensor,
    cfg: SparseProxConfig = SparseProxConfig(),
    alpha=None,
) -> torch.Tensor:
    """:func:`pnp_ista_blocks` in one launch of kernel B1 and nothing else
    on the card (with ``alpha`` given); takes CUDA tensors and the
    ``nlm_fast`` denoiser only and raises on anything else, and on a shape the
    kernel does not take."""
    if cfg.denoiser != "nlm_fast":
        raise ValueError(
            f"kernel B1 runs the nlm_fast denoiser only, not {cfg.denoiser!r}: "
            "sparse_prox runs the plain loop for the others"
        )
    for name, t in (("blocks", blocks), ("mask_blocks", mask_blocks), ("D", D)):
        if t.device.type != "cuda" or t.device != blocks.device:
            raise ValueError(f"{name} must be on the CUDA device {blocks.device}, got {t.device}")
    if mask_blocks.shape != blocks.shape or D.ndim != 2 or D.shape[0] != blocks.shape[1]:
        raise ValueError(
            f"shapes do not fit: blocks {tuple(blocks.shape)}, mask_blocks "
            f"{tuple(mask_blocks.shape)}, D {tuple(D.shape)}"
        )
    if cfg.matmul_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown matmul_dtype {cfg.matmul_dtype!r}")
    Y = blocks.to(torch.float32).contiguous()
    M = mask_blocks.to(torch.float32).contiguous()
    D = D.to(torch.float32)
    if alpha is None:
        alpha = compute_alpha(D, M, cfg)
    # The kernel masks Y, clamps alpha and derives 1/alpha and the NLM's
    # h = h_scale * lambda / (2 alpha) itself, as _prepare does for the plain loop.
    return ISTA_KERNEL.launch(
        Y, M, D, alpha.to(torch.float32), cfg.h_scale * cfg.lambda_ista,
        cfg.n_iter, cfg.matmul_dtype == "bfloat16",
    )


def use_kernel(blocks: torch.Tensor, cfg: SparseProxConfig) -> bool:
    """Whether :func:`sparse_prox` launches kernel B1: for CUDA tensors with
    the ``nlm_fast`` denoiser, unless ``cfg.backend`` is ``"xla"`` (the
    counterpart of the JAX package's ``_use_pallas``; ``"auto"`` and
    ``"pallas"`` both take the kernel on the card)."""
    if cfg.backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    return blocks.is_cuda and cfg.denoiser == "nlm_fast" and cfg.backend != "xla"


def sparse_coefs(
    blocks: torch.Tensor,
    mask_blocks: torch.Tensor,
    D: torch.Tensor,
    cfg: SparseProxConfig = SparseProxConfig(),
    alpha=None,
) -> torch.Tensor:
    """The ISTA coefficients (nB, K) of every block: kernel B1 where
    :func:`use_kernel` says so, the plain loop otherwise."""
    ista = pnp_ista_blocks_fused if use_kernel(blocks, cfg) else pnp_ista_blocks
    return ista(blocks, mask_blocks, D, cfg, alpha=alpha)


def sparse_prox(
    blocks: torch.Tensor,
    mask_blocks: torch.Tensor,
    D: torch.Tensor,
    cfg: SparseProxConfig = SparseProxConfig(),
    alpha=None,
) -> torch.Tensor:
    """Full sparse-coding prox: ISTA coefficients + full-dictionary
    reconstruction (reference ``Phi_z[:, j] = D @ Coefs``).  Returns the
    reconstructed blocks (nB, P)."""
    return sparse_coefs(blocks, mask_blocks, D, cfg, alpha=alpha) @ D.to(torch.float32).T
