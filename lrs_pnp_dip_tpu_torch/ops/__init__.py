from .blocks import BlockGrid, block_grid, extract_blocks, scatter_blocks
from .fidelity import data_fidelity_update, dual_updates
from .ista import compute_alpha, pnp_ista_blocks, pnp_ista_blocks_fused, sparse_prox
from .ista_cuda import ISTA_KERNEL
from .metrics import batch_mpsnr, mpsnr, psnr_ref
from .nlm import nlm_column_batch_fast
from .ssim import ssim

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
    "sparse_prox",
    "ssim",
]
