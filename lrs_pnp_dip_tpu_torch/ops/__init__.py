from .blocks import BlockGrid, block_grid, extract_blocks, scatter_blocks
from .fidelity import data_fidelity_update, dual_updates
from .ista import compute_alpha, pnp_ista_blocks, pnp_ista_blocks_fused, sparse_prox
from .ista_cuda import ISTA_KERNEL
from .metrics import batch_mpsnr, mpsnr, psnr_ref
from .nlm import nlm_column_batch_fast
from .shrinkage import soft_threshold
from .ssim import ssim
from .svt import singular_energy_ratio, singular_values_gram, svt, svt_gram

__all__ = [
    "BlockGrid",
    "ISTA_KERNEL",
    "batch_mpsnr",
    "block_grid",
    "compute_alpha",
    "data_fidelity_update",
    "dual_updates",
    "extract_blocks",
    "mpsnr",
    "nlm_column_batch_fast",
    "pnp_ista_blocks",
    "pnp_ista_blocks_fused",
    "psnr_ref",
    "scatter_blocks",
    "singular_energy_ratio",
    "singular_values_gram",
    "soft_threshold",
    "sparse_prox",
    "ssim",
    "svt",
    "svt_gram",
]
