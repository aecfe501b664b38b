"""Data layer: .mat readers and the canonical HSI tensor layout
(counterpart of ``lrs_pnp_dip_tpu/data/io.py``).

  * image cube:  ``(H, W, B)`` float32;
  * mask:        ``(H, W)`` float32 in {0, 1}; 1 = observed, 0 = missing;
  * matricized:  ``(H*W, B)`` with row-major pixel index ``p = h*W + w``.

The reference stores .mat cubes as MATLAB ``(H, W, B, 1)`` (v7.3/HDF5) or
``(1, B, H, W)`` (v5); the loaders turn both into the canonical ``(H, W, B)``
such that ``cube[h, w, b]`` lines up with ``mask[h, w]``.  scipy reads v5
files; v7.3 files go through ``h5py``, imported only when one is met.

``matricize``/``unmatricize`` take numpy arrays or torch tensors alike.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

# The reference data: the directory named by LRS_REFERENCE_DATA, else
# ``reference/data`` at the root of the repository.
_REFERENCE_DATA_DIR = os.environ.get(
    "LRS_REFERENCE_DATA",
    os.path.join(os.path.dirname(__file__), "..", "..", "reference", "data"),
)


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

    @property
    def n_pixels(self) -> int:
        h, w, _ = self.noisy.shape
        return h * w

    @property
    def n_bands(self) -> int:
        return self.noisy.shape[-1]


def load_mat_array(path: str, key: str) -> np.ndarray:
    """Load one variable from a .mat file, v5 or v7.3, in MATLAB dimension
    order.  h5py presents a v7.3 (HDF5) array with its dimensions reversed,
    so they are reversed back."""
    from scipy.io import loadmat

    try:
        return np.asarray(loadmat(path)[key])
    except (ValueError, NotImplementedError):
        import h5py

        with h5py.File(path, "r") as f:
            arr = np.asarray(f[key])
        return arr.transpose(tuple(reversed(range(arr.ndim))))


def _to_canonical_cube(arr: np.ndarray) -> np.ndarray:
    """Normalise a loaded .mat cube into canonical (H, W, B) float32.

    Accepts the two on-disk layouts the reference data uses:
      * (H, W, B, 1)  — MATLAB order (v7.3 files after reversal, and v5)
      * (1, B, H, W)  — the pre-permuted v5 layout of
        ``low_rank_sparsity_noisy.mat``
    """
    arr = np.asarray(arr)
    if arr.ndim == 4:
        if arr.shape[-1] == 1:  # (H, W, B, 1)
            arr = arr[..., 0]
        elif arr.shape[0] == 1:  # (1, B, H, W)
            arr = arr[0].transpose(1, 2, 0)
        else:
            raise ValueError(f"unrecognised cube shape {arr.shape}")
    elif arr.ndim != 3:
        raise ValueError(f"unrecognised cube shape {arr.shape}")
    return np.ascontiguousarray(arr, dtype=np.float32)


def load_mask(path: str, key: str = "msk") -> np.ndarray:
    """Load an observation mask as canonical (H, W) float32 {0,1}; the
    reference stores masks (1, 1, H, W) in v5 .mat files."""
    arr = np.asarray(load_mat_array(path, key))
    arr = arr.reshape(arr.shape[-2], arr.shape[-1])
    return np.ascontiguousarray(arr, dtype=np.float32)


def load_sample(
    noisy_path: str,
    mask_path: str,
    clean_path: Optional[str] = None,
    name: str = "sample",
) -> HsiSample:
    """Load one inpainting problem from reference-format .mat files."""
    noisy = _to_canonical_cube(load_mat_array(noisy_path, "masked_image"))
    mask = load_mask(mask_path)
    clean = None
    if clean_path is not None:
        clean = _to_canonical_cube(load_mat_array(clean_path, "clean_image"))
    return HsiSample(noisy=noisy, mask=mask, clean=clean, name=name)


# The five reference test images and four masks.
REFERENCE_IMAGES = {
    "img1": ("low_rank_sparsity_noisy.mat", "low_rank_sparsity_clean.mat"),
    "img2": ("low_rank_sparsity_noisy_img2.mat", "low_rank_sparsity_clean_img2.mat"),
    "img3": ("low_rank_sparsity_noisy_img3.mat", "low_rank_sparsity_clean_img3.mat"),
    "img4": ("low_rank_sparsity_noisy_img4.mat", "low_rank_sparsity_clean_img4.mat"),
    "img5": ("low_rank_sparsity_noisy_img5.mat", "low_rank_sparsity_clean_img5.mat"),
}
REFERENCE_MASKS = {
    "mask1": "low_rank_sparsity_mask.mat",
    "mask2": "second_mask.mat",
    "mask3": "third_mask.mat",
    "mask4": "fourth_mask.mat",
}

# Each noisy file has its mask baked in (missing pixels are stored as 0).
REFERENCE_PAIRS = {
    "img1": "mask1",
    "img2": "mask2",
    "img3": "mask3",
    "img4": "mask4",
    "img5": "mask4",
}


def reference_data_available(data_dir: str = _REFERENCE_DATA_DIR) -> bool:
    return os.path.isdir(data_dir) and os.path.exists(
        os.path.join(data_dir, REFERENCE_MASKS["mask1"])
    )


def load_reference_sample(
    image: str = "img1",
    mask: str = "mask1",
    data_dir: str = _REFERENCE_DATA_DIR,
) -> HsiSample:
    """Load one of the five reference test images with one of the four masks."""
    noisy_fn, clean_fn = REFERENCE_IMAGES[image]
    return load_sample(
        os.path.join(data_dir, noisy_fn),
        os.path.join(data_dir, REFERENCE_MASKS[mask]),
        os.path.join(data_dir, clean_fn),
        name=f"{image}+{mask}",
    )


def load_reference_pair(image: str, data_dir: str = _REFERENCE_DATA_DIR) -> HsiSample:
    """Load a reference image with its own (baked-in) mask."""
    return load_reference_sample(image, REFERENCE_PAIRS[image], data_dir)


def matricize(cube):
    """(H, W, B) -> (H*W, B), pixels row-major (p = h*W + w)."""
    h, w, b = cube.shape
    return cube.reshape(h * w, b)


def unmatricize(mat, height: int, width: int):
    """(H*W, B) -> (H, W, B)."""
    return mat.reshape(height, width, -1)
