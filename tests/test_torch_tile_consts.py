"""The tile pipeline's batched constant build against the per-tile one.

``solve_tiled`` builds a batch's :class:`ProblemConsts` and initial state in
one pass over the stacked tiles (``_TileBatch.build``: one power iteration
over the blocks of every tile).  It must give what ``make_consts`` and
``init_state`` give tile by tile, stacked: every field bit for bit but the
step sizes, which are held to rtol 1e-6 (a GEMM over more rows may sum in
another order), and the same generators.  Each case builds twice on one
batch shape, so both the first build and the refill of its kept tensors
are checked."""

import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu_torch.data import HsiSample, bernoulli_mask, synthetic_sample
from lrs_pnp_dip_tpu_torch.solvers import init_state, make_consts, stack_consts, stack_states
from lrs_pnp_dip_tpu_torch.solvers.tiled import _tiled_engine
from lrs_pnp_dip_tpu_torch.utils import config as tconfig

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

TILE = (16, 16, 8)
TILE_BATCH = 4


def _config(variant, alpha_mode):
    sparse = tconfig.SparseProxConfig(n_iter=2, alpha_mode=alpha_mode)
    if variant == "lrs_pnp":
        return tconfig.SolverConfig(variant="lrs_pnp", block_size=8, stride=8, dip=None, seed=7, sparse=sparse)
    return tconfig.SolverConfig(variant="dip_1lip", block_size=8, stride=8, net_width=8, seed=7, sparse=sparse,
                                dip=tconfig.DipConfig(num_iter=1, buffer_size=2))


def _tiles(lanes, seed):
    """(lanes, 16, 16, 8) observed tiles, zero where missing, and their masks."""
    clean = synthetic_sample(TILE[0] * lanes, TILE[1], TILE[2], missing=0.0, seed=seed).clean
    mask = bernoulli_mask(clean.shape[:2], 0.85, seed=seed + 1).astype(np.float32)
    noisy = (clean * mask[..., None]).astype(np.float32)
    return (np.ascontiguousarray(noisy.reshape(lanes, *TILE)),
            np.ascontiguousarray(mask.reshape(lanes, *TILE[:2])))


def _dictionary(seed):
    D = np.random.default_rng(seed).standard_normal((64, 32)).astype(np.float32)
    return D / np.linalg.norm(D, axis=0, keepdims=True)


@pytest.mark.parametrize("variant", ["lrs_pnp", "dip_1lip"])
@pytest.mark.parametrize("lanes", [TILE_BATCH, 2], ids=["full", "partial"])
@pytest.mark.parametrize("alpha_mode", ["trace4", "specnorm"])
def test_batched_build_equals_the_per_tile_build(alpha_mode, lanes, variant):
    cfg = _config(variant, alpha_mode)
    cpu = torch.device("cpu")
    engine = _tiled_engine(cfg, TILE, None, cpu)
    D_np = _dictionary(3)
    batch = engine.batch(lanes, engine.dictionary(D_np))
    for seed in (11, 21):  # the first build, then a refill of its tensors
        tiles, masks = _tiles(lanes, seed)
        consts, state = batch.build(tiles, masks, cfg.seed)
        per_tile = [make_consts(HsiSample(noisy=t, mask=m), D_np, cfg, device="cpu") for t, m in zip(tiles, masks)]
        want = stack_consts(per_tile)
        want_state = stack_states([init_state(c.Y, cfg.seed + i, device="cpu") for i, c in enumerate(per_tile)])
        for name in want._fields:
            got, ref = getattr(consts, name), getattr(want, name)
            assert got.shape == ref.shape and got.dtype == ref.dtype, name
            if name == "alpha":
                torch.testing.assert_close(got, ref, rtol=1e-6, atol=0.0)
            else:
                assert torch.equal(got, ref) or (name == "clean" and got.isnan().all() and ref.isnan().all()), name
        for name in ("X", "lambda1", "lambda2"):
            assert torch.equal(getattr(state, name), getattr(want_state, name)), name
        assert state.itr == want_state.itr == 0
        assert len(state.generator) == lanes
        for g, ref in zip(state.generator, want_state.generator):
            assert g.initial_seed() == ref.initial_seed()
            assert torch.equal(torch.rand(5, generator=g), torch.rand(5, generator=ref))
