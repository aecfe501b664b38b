from .dictionary import column_normalize, learn_dictionary, load_trained_dictionary, random_dictionary
from .io import HsiSample, load_mask, load_mat_array, load_sample, matricize, unmatricize
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
    "column_normalize",
    "corrupt",
    "learn_dictionary",
    "load_mask",
    "load_mat_array",
    "load_sample",
    "load_trained_dictionary",
    "matlab_strip_mask",
    "matlab_twin_sample",
    "matricize",
    "mmap_cube",
    "random_dictionary",
    "strip_mask",
    "synthetic_sample",
    "text_mask",
    "tile_origins",
    "unmatricize",
]
