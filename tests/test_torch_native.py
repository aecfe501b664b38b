"""The port's bindings to the native host library (``lrs_pnp_dip_tpu_torch/native.py``)
against the JAX package's bindings to the same source, and against the
port's torch functions.  Skipped where no host compiler builds the library,
as tests/test_native.py is.

The two bindings load libraries built from one source with the same flags,
so they agree exactly.  Against torch: block extraction and tile extraction
are copies (exact); the sum-scatter is exact where no entry is covered by
more than two blocks (a + b == b + a), and within 1e-6 elsewhere (the order
of three or more terms); the NLMs within rtol 2e-4 / atol 2e-5, as
tests/test_native.py holds the library to the JAX package (the library sums
in double)."""

import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu import native as jnative
from lrs_pnp_dip_tpu_torch import native
from lrs_pnp_dip_tpu_torch.data.tiles import TileLoader, tile_origins
from lrs_pnp_dip_tpu_torch.ops.blocks import block_grid, extract_blocks, scatter_blocks
from lrs_pnp_dip_tpu_torch.ops.nlm import nlm2d, nlm_column_batch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("no host compiler builds the native library")
    return native


def test_library_builds_into_the_ports_build_directory(built):
    path = built.LIBRARY.build()
    assert path.parent.name == "build" and path.parent.parent.name == "csrc"
    assert path.name.startswith("liblrs_native_") and path.exists()


@pytest.mark.parametrize("h", [0.05, 0.5])
def test_nlm2d_matches_the_jax_bindings_and_torch(built, h):
    img = np.random.default_rng(0).random((15, 9)).astype(np.float32)
    ours = built.nlm2d(img, h)
    if jnative.available():
        np.testing.assert_array_equal(ours, jnative.nlm2d(img, h))
    np.testing.assert_allclose(ours, nlm2d(torch.from_numpy(img), h).numpy(), rtol=2e-4, atol=2e-5)


def test_nlm_column_batch_matches_the_jax_bindings_and_torch(built):
    V = np.random.default_rng(1).random((6, 40)).astype(np.float32)
    h = np.linspace(0.05, 0.3, 6).astype(np.float32)
    ours = built.nlm_column_batch(V, h)
    if jnative.available():
        np.testing.assert_array_equal(ours, jnative.nlm_column_batch(V, h))
    ref = nlm_column_batch(torch.from_numpy(V), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="h"):
        built.nlm_column_batch(V, h[:5])


@pytest.mark.parametrize("shape,bb,stride,exact", [
    ((60, 23), 8, 5, False),  # overlapping blocks: up to 4 terms per entry
    ((36 * 36, 128), 36, 36, True),  # the dip solve's grid: at most 2 terms
    ((12 * 12, 16), 6, 6, True),
])
def test_blocks_match_the_jax_bindings_and_torch(built, shape, bb, stride, exact):
    Y = np.random.default_rng(2).random(shape).astype(np.float32)
    grid = block_grid(shape, bb, stride)
    ours = built.extract_blocks(Y, bb, stride)
    np.testing.assert_array_equal(ours, extract_blocks(torch.from_numpy(Y), grid).numpy())
    im, wt = built.scatter_blocks(ours, shape, bb, stride)
    ref = scatter_blocks(torch.from_numpy(ours), grid).numpy()
    if exact:
        np.testing.assert_array_equal(im, ref)
    else:
        np.testing.assert_allclose(im, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(wt, grid.weight().numpy())
    if jnative.available():
        np.testing.assert_array_equal(ours, jnative.extract_blocks(Y, bb, stride))
        np.testing.assert_array_equal(im, jnative.scatter_blocks(ours, shape, bb, stride)[0])
    with pytest.raises(ValueError, match="blocks must have shape"):
        built.scatter_blocks(ours[1:], shape, bb, stride)


def test_tiles_are_numpy_slices(built):
    cube = np.random.default_rng(3).random((40, 32, 7)).astype(np.float32)
    origins = tile_origins(40, 32, 16, 12, 10, 9)
    tiles = built.extract_tiles(cube, origins, 16, 12)
    for tile, (h0, w0) in zip(tiles, origins):
        np.testing.assert_array_equal(tile, cube[h0 : h0 + 16, w0 : w0 + 12])
    with pytest.raises(ValueError, match="leaves"):
        built.extract_tiles(cube, np.array([[30, 0]], np.int32), 16, 12)


def test_tile_loader_takes_the_native_extractor(built):
    """TileLoader(use_native=None) takes the library for a C-contiguous
    array and numpy slicing for a strided view; both give the same tiles."""
    cube = np.random.default_rng(4).random((40, 32, 7)).astype(np.float32)
    native_loader = TileLoader(cube, (16, 16), batch_size=3)
    assert native_loader.native
    strided = cube[:, ::-1]
    assert not TileLoader(strided, (16, 16), batch_size=3).native
    numpy_loader = TileLoader(cube, (16, 16), batch_size=3, use_native=False)
    for (a, oa), (b, ob) in zip(native_loader.batches(), numpy_loader.batches()):
        np.testing.assert_array_equal(oa, ob)
        np.testing.assert_array_equal(a, b)
