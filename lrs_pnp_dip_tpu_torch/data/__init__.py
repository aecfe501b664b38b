from .dictionary import load_trained_dictionary
from .io import HsiSample, matricize, unmatricize
from .masks import bernoulli_mask, corrupt, synthetic_sample
from .tiles import TileLoader, mmap_cube, tile_origins

__all__ = [
    "HsiSample",
    "TileLoader",
    "bernoulli_mask",
    "corrupt",
    "load_trained_dictionary",
    "matricize",
    "mmap_cube",
    "synthetic_sample",
    "tile_origins",
    "unmatricize",
]
