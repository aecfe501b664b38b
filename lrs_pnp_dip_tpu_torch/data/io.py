"""The canonical HSI tensor layout (counterpart of ``lrs_pnp_dip_tpu/data/io.py``).

  * image cube:  ``(H, W, B)`` float32;
  * mask:        ``(H, W)`` float32 in {0, 1}; 1 = observed, 0 = missing;
  * matricized:  ``(H*W, B)`` with row-major pixel index ``p = h*W + w``.

``matricize``/``unmatricize`` take numpy arrays or torch tensors alike.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class HsiSample:
    """One hyperspectral inpainting problem instance.

    Attributes:
      noisy: (H, W, B) observed cube — noise added on observed pixels,
        missing pixels zeroed.
      mask:  (H, W) observation mask, 1 = observed.
      clean: optional (H, W, B) ground truth for evaluation.
      name:  identifier for logging.
    """

    noisy: np.ndarray
    mask: np.ndarray
    clean: Optional[np.ndarray] = None
    name: str = "sample"

    @property
    def shape(self):
        return self.noisy.shape


def matricize(cube):
    """(H, W, B) -> (H*W, B), pixels row-major (p = h*W + w)."""
    h, w, b = cube.shape
    return cube.reshape(h * w, b)


def unmatricize(mat, height: int, width: int):
    """(H*W, B) -> (H, W, B)."""
    return mat.reshape(height, width, -1)
