"""Tiled-cube data pipeline for large hyperspectral scenes (counterpart of
``lrs_pnp_dip_tpu/data/tiles.py``).

  * ``tile_origins``: the tile grid, with the block grid's rule that the last
    row/column of tiles is pulled in so every pixel is covered;
  * ``TileLoader``: a double-buffered iterator over tile batches: while batch
    k is being solved, batch k+1 is extracted on a background thread, by the
    native host library (a memcpy per tile row, OpenMP over tiles,
    ``native/lrs_native.cc:extract_tiles``) when it builds, else by numpy
    slicing; both give the same bits;
  * ``mmap_cube``: zero-copy load of an ``.npy`` cube.
"""

from __future__ import annotations

import concurrent.futures
from typing import Iterator, Optional, Tuple

import numpy as np

from ..utils.profiling import annotate


def tile_origins(
    height: int, width: int, tile_h: int, tile_w: int,
    stride_h: Optional[int] = None, stride_w: Optional[int] = None,
) -> np.ndarray:
    """(N, 2) array of (h0, w0) origins covering the scene; the final
    row/col of tiles is pulled in so every pixel is covered."""

    def starts(extent, size, stride):
        stride = stride or size
        s = list(range(0, extent - size + 1, stride))
        if not s or s[-1] != extent - size:
            s.append(extent - size)
        return s

    hs = starts(height, tile_h, stride_h)
    ws = starts(width, tile_w, stride_w)
    return np.asarray([(h, w) for h in hs for w in ws], dtype=np.int32)


def mmap_cube(path: str) -> np.ndarray:
    """Memory-map a .npy (H, W, B) float32 cube."""
    return np.load(path, mmap_mode="r")


def _extract_batch_numpy(cube, origins, th, tw):
    out = np.empty((len(origins), th, tw, cube.shape[2]), np.float32)
    for i, (h0, w0) in enumerate(origins):
        out[i] = cube[h0 : h0 + th, w0 : w0 + tw, :]
    return out


class TileLoader:
    """Double-buffered tile-batch iterator: while batch k is being consumed
    (by the solver, say), batch k+1 is extracted on a background thread.
    The thread lives for one pass of :meth:`batches`.

    ``use_native=None`` takes the native extractor when the library builds
    and the cube is a C-contiguous numpy array (a memory map included);
    ``native`` says which extractor was taken."""

    def __init__(
        self,
        cube: np.ndarray,
        tile_shape: Tuple[int, int],
        batch_size: int = 8,
        stride: Optional[Tuple[int, int]] = None,
        use_native: Optional[bool] = None,
    ):
        self.cube = cube
        self.th, self.tw = tile_shape
        self.batch_size = batch_size
        sh, sw = stride or (None, None)
        self.origins = tile_origins(cube.shape[0], cube.shape[1], self.th, self.tw, sh, sw)
        from .. import native

        if use_native is None:
            use_native = (
                isinstance(cube, np.ndarray)
                and bool(cube.flags["C_CONTIGUOUS"])
                and native.available()
            )
        self.native = bool(use_native)
        self._extract = native.extract_tiles if use_native else _extract_batch_numpy

    @property
    def n_tiles(self) -> int:
        return len(self.origins)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self.batches()

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (tiles, origins) with background prefetch."""
        batch_list = [
            self.origins[i : i + self.batch_size]
            for i in range(0, len(self.origins), self.batch_size)
        ]
        if not batch_list:
            return
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(self._extract, self.cube, batch_list[0], self.th, self.tw)
            for j, origins in enumerate(batch_list):
                with annotate("tiles.wait"):
                    cur = future.result()
                if j + 1 < len(batch_list):
                    future = pool.submit(
                        self._extract, self.cube, batch_list[j + 1], self.th, self.tw
                    )
                yield cur, origins
