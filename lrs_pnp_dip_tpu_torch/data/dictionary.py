"""The shipped patch dictionary (counterpart of
``lrs_pnp_dip_tpu/data/dictionary.py:load_trained_dictionary``).

Dictionary learning is not ported yet (ROADMAP Queue A, item 14)."""

from __future__ import annotations

import os

import numpy as np

_ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "artifacts")


def load_trained_dictionary(n_atoms: int = 512) -> np.ndarray:
    """Load ``artifacts/dictionary_36x36_k{n_atoms}.npz`` as a (1296, n_atoms)
    float32 array."""
    path = os.path.join(_ARTIFACTS, f"dictionary_36x36_k{n_atoms}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found")
    with np.load(path) as f:
        return np.asarray(f["dictionary"], dtype=np.float32)
