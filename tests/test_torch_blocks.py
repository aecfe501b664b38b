"""The port's config, data layer and block layout against the JAX package.

Everything here is index arithmetic or seeded numpy, so the comparisons are
exact (no tolerance)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.data import masks as jmasks
from lrs_pnp_dip_tpu.data.dictionary import load_trained_dictionary as j_load_dict
from lrs_pnp_dip_tpu.data.io import matricize as j_matricize
from lrs_pnp_dip_tpu.ops import blocks as jblocks
from lrs_pnp_dip_tpu.utils import config as jconfig
from lrs_pnp_dip_tpu_torch.data import (
    bernoulli_mask,
    corrupt,
    load_trained_dictionary,
    matricize,
    synthetic_sample,
    unmatricize,
)
from lrs_pnp_dip_tpu_torch.ops import blocks as tblocks
from lrs_pnp_dip_tpu_torch.utils import config as tconfig

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_presets_match_field_for_field(name):
    ours = dataclasses.asdict(tconfig.PRESETS[name]())
    ref = dataclasses.asdict(jconfig.PRESETS[name]())
    assert ours == ref
    assert set(tconfig.PRESETS) == set(jconfig.PRESETS)


def test_default_configs_match():
    from lrs_pnp_dip_tpu.ops.ista import SparseProxConfig as JSparse

    assert dataclasses.asdict(tconfig.SparseProxConfig()) == dataclasses.asdict(JSparse())
    assert dataclasses.asdict(tconfig.DipConfig()) == dataclasses.asdict(jconfig.DipConfig())
    assert dataclasses.asdict(tconfig.SolverConfig()) == dataclasses.asdict(jconfig.SolverConfig())


def test_data_layer_is_seeded_identically():
    ours = synthetic_sample(12, 10, 16, rank=3, missing=0.2, seed=5)
    ref = jmasks.synthetic_sample(12, 10, 16, rank=3, missing=0.2, seed=5)
    for a, b in ((ours.noisy, ref.noisy), (ours.mask, ref.mask), (ours.clean, ref.clean)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(
        bernoulli_mask((7, 9), 0.7, seed=2), jmasks.bernoulli_mask((7, 9), 0.7, seed=2)
    )
    np.testing.assert_array_equal(
        corrupt(ref.clean, ref.mask, 0.1, seed=4),
        jmasks.corrupt(ref.clean, ref.mask, 0.1, seed=4),
    )
    mat = matricize(torch.from_numpy(ref.noisy))
    np.testing.assert_array_equal(mat.numpy(), j_matricize(ref.noisy))
    np.testing.assert_array_equal(unmatricize(mat, 12, 10).numpy(), ref.noisy)


def test_shipped_dictionary_loads_identically():
    ours = load_trained_dictionary(512)
    assert ours.shape == (1296, 512) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, np.asarray(j_load_dict(512), np.float32))


# (n_pixels, n_bands, block_size, stride): the reference geometry (regular
# fast path), the 144x144 cube, bands not divisible by bb (band-start
# append), and two geometries on the general gather path.
GRIDS = [
    (36 * 36, 128, 36, 36),
    (144 * 144, 128, 36, 36),
    (12 * 12, 16, 6, 6),
    (100, 20, 6, 4),
    (50, 13, 5, 3),
]


@pytest.mark.parametrize("geom", GRIDS)
def test_blocks_match_exactly(geom):
    P, B, bb, stride = geom
    g_t = tblocks.block_grid((P, B), bb, stride)
    g_j = jblocks.block_grid((P, B), bb, stride)
    assert g_t.x_starts == g_j.x_starts and g_t.y_starts == g_j.y_starts
    assert (tblocks._regular_layout(g_t) is None) == (jblocks._regular_layout(g_j) is None)

    rng = np.random.default_rng(P + B)
    Y = rng.standard_normal((P, B)).astype(np.float32)
    ours = tblocks.extract_blocks(torch.from_numpy(Y), g_t).numpy()
    ref = np.asarray(jblocks.extract_blocks(jnp.asarray(Y), g_j))
    np.testing.assert_array_equal(ours, ref)

    # integer-valued blocks: overlapping sums are exact in any order
    blk = rng.integers(-8, 9, size=ref.shape).astype(np.float32)
    ours = tblocks.scatter_blocks(torch.from_numpy(blk), g_t).numpy()
    ref = np.asarray(jblocks.scatter_blocks(jnp.asarray(blk), g_j))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(g_t.weight().numpy(), np.asarray(g_j.weight()))
