from . import proxlib
from .blocks import BlockGrid, block_grid, extract_blocks, scatter_blocks
from .bm3d import Bm3dConfig, bm3d, bm3d_coef_batch, bm3d_prox
from .fidelity import data_fidelity_update, dual_updates
from .ista import (
    compute_alpha, pnp_ista_blocks, pnp_ista_blocks_fused, sparse_coefs, sparse_prox, use_kernel,
)
from .ista_cuda import ISTA_KERNEL
from .metrics import batch_mpsnr, mpsnr, mse, psnr_ref, psnr_standard
from .nlm import (
    nlm2d, nlm_classic, nlm_classic_column_batch, nlm_column, nlm_column_batch,
    nlm_column_batch_fast,
)
from .shrinkage import soft_threshold
from .spectral_norm_cuda import SN_KERNEL
from .ssim import ssim, ssim_matlab
from .svt import singular_energy_ratio, singular_values_gram, svt, svt_gram

__all__ = [
    "BlockGrid",
    "Bm3dConfig",
    "ISTA_KERNEL",
    "SN_KERNEL",
    "batch_mpsnr",
    "block_grid",
    "bm3d",
    "bm3d_coef_batch",
    "bm3d_prox",
    "compute_alpha",
    "data_fidelity_update",
    "dual_updates",
    "extract_blocks",
    "mpsnr",
    "mse",
    "nlm2d",
    "nlm_classic",
    "nlm_classic_column_batch",
    "nlm_column",
    "nlm_column_batch",
    "nlm_column_batch_fast",
    "pnp_ista_blocks",
    "pnp_ista_blocks_fused",
    "proxlib",
    "psnr_ref",
    "psnr_standard",
    "scatter_blocks",
    "singular_energy_ratio",
    "singular_values_gram",
    "soft_threshold",
    "sparse_coefs",
    "sparse_prox",
    "ssim",
    "ssim_matlab",
    "svt",
    "svt_gram",
    "use_kernel",
]
