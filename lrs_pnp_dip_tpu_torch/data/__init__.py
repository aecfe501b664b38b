from .dictionary import load_trained_dictionary
from .io import HsiSample, matricize, unmatricize
from .masks import bernoulli_mask, corrupt, synthetic_sample

__all__ = [
    "HsiSample",
    "bernoulli_mask",
    "corrupt",
    "load_trained_dictionary",
    "matricize",
    "synthetic_sample",
    "unmatricize",
]
