"""Overlapping block extraction/scatter over the matricized (pixels x bands)
image (counterpart of ``lrs_pnp_dip_tpu/ops/blocks.py``).

Each block spans ``bb`` consecutive pixels by ``bb`` consecutive bands,
with stride ``slidingDis`` and the reference's "append the last start if
the extent is not divisible by bb" rule (``main_LRS_PnP_DIP_pro.py:123-157``).

Layouts match the JAX package exactly:
  * ``extract_blocks`` returns ``(n_blocks, bb*bb)``;
  * entries inside a block are band-major (``blk[j, b_local*bb + p_local]``);
  * blocks are ordered band-start-slow (all pixel starts for the first band
    start, then the next band start, ...).

When the pixel starts tile the pixel axis exactly (stride == bb and
P % bb == 0, true for the reference geometry) extraction and scatter are
reshapes and slice adds; otherwise they are one gather / one
accumulating ``index_put_``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch


def _start_indices(extent: int, bb: int, stride: int) -> np.ndarray:
    """Block start offsets along one axis, with the reference's append rule."""
    last = extent - bb
    if last < 0:
        raise ValueError(
            f"block_size {bb} exceeds extent {extent}; blocks must fit inside "
            "the matricized image"
        )
    starts = list(range(0, last + 1, stride))
    if extent % bb != 0 and starts[-1] != last:
        starts.append(last)
    return np.asarray(starts, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class BlockGrid:
    """Static description of the overlapping-block layout."""

    shape: Tuple[int, int]  # (n_pixels, n_bands) of the matricized image
    block_size: int
    stride: int
    x_starts: Tuple[int, ...]  # per block, pixel-axis start
    y_starts: Tuple[int, ...]  # per block, band-axis start

    @property
    def n_blocks(self) -> int:
        return len(self.x_starts)

    @property
    def patch_dim(self) -> int:
        return self.block_size * self.block_size

    def weight(self, device="cpu") -> torch.Tensor:
        """Per-entry block-coverage count (reference ``Weight``), (P, B),
        made once per device and shared: do not write to it."""
        return _coverage(self, torch.device(device))


@functools.lru_cache(maxsize=None)
def block_grid(shape: Tuple[int, int], block_size: int, stride: int) -> BlockGrid:
    """Build the static block grid for a matricized image shape."""
    n_pix, n_band = shape
    xs = _start_indices(n_pix, block_size, stride)
    ys = _start_indices(n_band, block_size, stride)
    x_rep = np.tile(xs, len(ys))  # band start is the slow axis
    y_rep = np.repeat(ys, len(xs))
    return BlockGrid(
        shape=(int(n_pix), int(n_band)),
        block_size=int(block_size),
        stride=int(stride),
        x_starts=tuple(int(v) for v in x_rep),
        y_starts=tuple(int(v) for v in y_rep),
    )


@functools.lru_cache(maxsize=None)
def _regular_layout(grid: BlockGrid):
    """(xs, ys) start tuples when the pixel starts are exactly the
    non-overlapping covering grid, else None."""
    bb, stride = grid.block_size, grid.stride
    P, B = grid.shape
    if stride != bb or P % bb != 0:
        return None
    xs = tuple(int(v) for v in _start_indices(P, bb, stride))
    ys = tuple(int(v) for v in _start_indices(B, bb, stride))
    if len(xs) * len(ys) != grid.n_blocks:
        return None
    if xs != tuple(range(0, P - bb + 1, bb)):
        return None
    return xs, ys


@functools.lru_cache(maxsize=64)
def _coverage(grid: BlockGrid, device: torch.device) -> torch.Tensor:
    ones = torch.ones((grid.n_blocks, grid.patch_dim), dtype=torch.float32, device=device)
    return scatter_blocks(ones, grid)


@functools.lru_cache(maxsize=64)
def _gather_indices(grid: BlockGrid, device: torch.device):
    """(nB, bb, bb) = [block, band_local, pixel_local] row/col indices, so a
    C-order flatten of the trailing two axes is band-major.  Made once per
    (grid, device): they come from host tuples, a copy that a captured
    graph cannot hold."""
    bb = grid.block_size
    xs = torch.tensor(grid.x_starts, dtype=torch.int64, device=device)
    ys = torch.tensor(grid.y_starts, dtype=torch.int64, device=device)
    d = torch.arange(bb, dtype=torch.int64, device=device)
    rows = (xs[:, None, None] + d[None, None, :]).expand(-1, bb, bb)
    cols = (ys[:, None, None] + d[None, :, None]).expand(-1, bb, bb)
    return rows, cols


def extract_blocks(Y: torch.Tensor, grid: BlockGrid) -> torch.Tensor:
    """Gather all blocks: (..., P, B) -> (..., n_blocks, bb*bb), band-major
    entries; leading axes stack problems of one grid."""
    bb = grid.block_size
    lead = Y.shape[:-2]
    fast = _regular_layout(grid)
    if fast is not None:
        xs, ys = fast
        nx = len(xs)
        parts = []
        for y0 in ys:
            seg = Y[..., y0 : y0 + bb].reshape(*lead, nx, bb, bb)  # [xblk, pix, band]
            parts.append(seg.transpose(-1, -2).reshape(*lead, nx, bb * bb))
        return torch.cat(parts, dim=-2)
    rows, cols = _gather_indices(grid, Y.device)
    return Y[..., rows, cols].reshape(*lead, grid.n_blocks, bb * bb)


def scatter_blocks(blocks: torch.Tensor, grid: BlockGrid) -> torch.Tensor:
    """Adjoint of :func:`extract_blocks`: sum-scatter blocks back to (P, B).

    Overlapping contributions accumulate (reference ``IMout`` /
    ``lambda1_summation``, ``main_LRS_PnP_DIP_pro.py:435-447``)."""
    bb = grid.block_size
    out = torch.zeros(grid.shape, dtype=blocks.dtype, device=blocks.device)
    fast = _regular_layout(grid)
    if fast is not None:
        xs, ys = fast
        nx = len(xs)
        P = grid.shape[0]
        b3 = blocks.reshape(grid.n_blocks, bb, bb)  # [block, band, pixel]
        for k, y0 in enumerate(ys):
            seg = b3[k * nx : (k + 1) * nx].transpose(1, 2).reshape(P, bb)
            out[:, y0 : y0 + bb] += seg
        return out
    rows, cols = _gather_indices(grid, blocks.device)
    out.index_put_(
        (rows, cols), blocks.reshape(grid.n_blocks, bb, bb), accumulate=True
    )
    return out
