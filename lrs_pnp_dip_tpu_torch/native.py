"""ctypes bindings to the native host library ``native/lrs_native.cc``
(counterpart of ``lrs_pnp_dip_tpu/native/__init__.py``).

Host-side C++: pairwise fast-NLM (2-D), the OpenMP-batched column NLM,
im2col block extraction and sum-scatter with the reference's append rule,
and the tile extractor that feeds :class:`..data.tiles.TileLoader`.  They
serve as independent test oracles and as the host-side data path; none of
them touches the card.

The library is compiled from the repository's source with the host
compiler and the flags of ``native/Makefile`` (``$CXX``, else ``g++``;
``$CXXFLAGS``, else the Makefile's; OpenMP where it links) at first use, into
``csrc/build/`` beside kernel B1's library, named by a hash of the source,
the compiler and the flags; ``native/`` is not written.
Nothing is compiled when this module is imported.  Every public function
raises :class:`NativeUnavailable` when the library cannot be built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parents[1] / "native" / "lrs_native.cc"
_BUILD_DIR = Path(__file__).resolve().parent / "csrc" / "build"
_CXXFLAGS = "-O3 -march=native -fPIC -std=c++17 -Wall"  # native/Makefile's


class NativeUnavailable(RuntimeError):
    pass


class NativeLibrary:
    """Builds and loads the library once per process."""

    def __init__(self):
        self._lib: Optional[ctypes.CDLL] = None

    def _command(self, openmp: bool) -> list:
        cxx = os.environ.get("CXX", "g++")
        flags = shlex.split(os.environ.get("CXXFLAGS", _CXXFLAGS))
        return [cxx, *flags, *(["-fopenmp"] if openmp else []), "-shared"]

    def build(self) -> Path:
        """Compile the source unless its library is built; returns its path.
        OpenMP is used where the compiler builds with it (a compiler may
        accept ``-fopenmp`` and still lack the runtime to link it); the
        source runs serially without it."""
        errors = []
        for openmp in (True, False):
            cmd = self._command(openmp)
            digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(cmd).encode()).hexdigest()[:16]
            path = _BUILD_DIR / f"liblrs_native_{digest}.so"
            if path.exists():
                return path
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            try:
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                subprocess.run(
                    [*cmd, "-o", str(tmp), str(_SOURCE)], check=True, capture_output=True, text=True
                )
            except subprocess.CalledProcessError as e:
                tmp.unlink(missing_ok=True)
                errors.append(f"{' '.join(cmd)}: {e.stderr.strip()}")
                continue
            except OSError as e:
                raise NativeUnavailable(f"cannot build the native library from {_SOURCE}: {e}") from e
            os.replace(tmp, path)
            return path
        raise NativeUnavailable(f"cannot build the native library from {_SOURCE}: " + "; ".join(errors))

    def load(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        path = self.build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeUnavailable(f"cannot load {path}: {e}") from e
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        c_int, c_float = ctypes.c_int, ctypes.c_float
        lib.nlm2d.argtypes = [f32p, c_int, c_int, c_float, c_int, c_int, f32p]
        lib.nlm2d.restype = None
        lib.nlm_column_batch.argtypes = [f32p, c_int, c_int, f32p, c_int, c_int, f32p]
        lib.nlm_column_batch.restype = None
        lib.n_blocks.argtypes = [c_int] * 4
        lib.n_blocks.restype = c_int
        lib.extract_blocks.argtypes = [f32p] + [c_int] * 4 + [f32p]
        lib.extract_blocks.restype = None
        lib.scatter_blocks.argtypes = [f32p] + [c_int] * 4 + [f32p, f32p]
        lib.scatter_blocks.restype = None
        lib.extract_tiles.argtypes = [f32p, c_int, c_int, c_int, i32p, c_int, c_int, c_int, f32p]
        lib.extract_tiles.restype = None
        self._lib = lib
        return lib


LIBRARY = NativeLibrary()


def available() -> bool:
    try:
        LIBRARY.load()
        return True
    except NativeUnavailable:
        return False


def nlm2d(image: np.ndarray, h: float, patch_size: int = 3, patch_distance: int = 3) -> np.ndarray:
    lib = LIBRARY.load()
    image = np.ascontiguousarray(image, np.float32)
    if image.ndim != 2:
        raise ValueError(f"image must be 2-D, got shape {image.shape}")
    out = np.empty_like(image)
    lib.nlm2d(image, image.shape[0], image.shape[1], h, patch_size, patch_distance, out)
    return out


def nlm_column_batch(
    vecs: np.ndarray, h: np.ndarray, patch_size: int = 3, patch_distance: int = 3
) -> np.ndarray:
    """NLM of each row of ``vecs`` (nB, K) as a (K, 1) image, with h per row."""
    lib = LIBRARY.load()
    vecs = np.ascontiguousarray(vecs, np.float32)
    h = np.ascontiguousarray(h, np.float32)
    if vecs.ndim != 2 or h.shape != (vecs.shape[0],):
        raise ValueError(f"needs vecs (nB, K) and h (nB,), got {vecs.shape} and {h.shape}")
    out = np.empty_like(vecs)
    lib.nlm_column_batch(vecs, vecs.shape[0], vecs.shape[1], h, patch_size, patch_distance, out)
    return out


def extract_blocks(Y: np.ndarray, block_size: int, stride: int) -> np.ndarray:
    """(n_pix, n_band) -> (nB, block_size**2) band-major blocks."""
    lib = LIBRARY.load()
    Y = np.ascontiguousarray(Y, np.float32)
    if Y.ndim != 2 or min(Y.shape) < block_size:
        raise ValueError(f"Y must be 2-D and at least {block_size} each way, got {Y.shape}")
    nb = lib.n_blocks(Y.shape[0], Y.shape[1], block_size, stride)
    out = np.empty((nb, block_size * block_size), np.float32)
    lib.extract_blocks(Y, Y.shape[0], Y.shape[1], block_size, stride, out)
    return out


def scatter_blocks(
    blocks: np.ndarray, shape: Tuple[int, int], block_size: int, stride: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Sum-scatter of blocks into a (n_pix, n_band) image, and the coverage."""
    lib = LIBRARY.load()
    blocks = np.ascontiguousarray(blocks, np.float32)
    if min(shape) < block_size:
        raise ValueError(f"shape {shape} is smaller than a block of {block_size}")
    nb = lib.n_blocks(shape[0], shape[1], block_size, stride)
    if blocks.shape != (nb, block_size * block_size):
        raise ValueError(f"blocks must have shape {(nb, block_size * block_size)}, got {blocks.shape}")
    out = np.empty(shape, np.float32)
    weight = np.empty(shape, np.float32)
    lib.scatter_blocks(blocks, shape[0], shape[1], block_size, stride, out, weight)
    return out, weight


def extract_tiles(cube: np.ndarray, origins: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Tiles (n, th, tw, B) of a (H, W, B) cube at the (h0, w0) ``origins``:
    a memcpy per tile row, OpenMP-parallel over tiles."""
    lib = LIBRARY.load()
    cube = np.ascontiguousarray(cube, np.float32)
    origins = np.ascontiguousarray(origins, np.int32).reshape(-1, 2)
    H, W, B = cube.shape
    if len(origins) and not (
        (origins >= 0).all() and (origins[:, 0] + th <= H).all() and (origins[:, 1] + tw <= W).all()
    ):
        raise ValueError(f"a {th}x{tw} tile at these origins leaves the {H}x{W} cube")
    out = np.empty((len(origins), th, tw, B), np.float32)
    lib.extract_tiles(cube, H, W, B, origins.reshape(-1), len(origins), th, tw, out.reshape(-1))
    return out
