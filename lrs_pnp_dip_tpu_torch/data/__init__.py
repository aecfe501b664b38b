from .dictionary import load_trained_dictionary
from .io import HsiSample, matricize, unmatricize
from .masks import (
    MATLAB_STRIPS, bernoulli_mask, corrupt, matlab_strip_mask, matlab_twin_sample, strip_mask,
    synthetic_sample, text_mask,
)
from .tiles import TileLoader, mmap_cube, tile_origins

__all__ = [
    "HsiSample",
    "MATLAB_STRIPS",
    "TileLoader",
    "bernoulli_mask",
    "corrupt",
    "load_trained_dictionary",
    "matlab_strip_mask",
    "matlab_twin_sample",
    "matricize",
    "mmap_cube",
    "strip_mask",
    "synthetic_sample",
    "text_mask",
    "tile_origins",
    "unmatricize",
]
