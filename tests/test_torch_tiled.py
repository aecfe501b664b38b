"""The port's tile pipeline and whole-scene solver against the JAX package.

``solve_tiled`` on `lrs_pnp` is deterministic and compared with the JAX
``solve_tiled`` at rtol / atol 2e-5, the tolerance at which
``tests/test_tiled.py`` holds the JAX package's two loops to each other."""

import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.data.tiles import TileLoader as JTileLoader
from lrs_pnp_dip_tpu.data.tiles import tile_origins as j_tile_origins
from lrs_pnp_dip_tpu.solvers.tiled import solve_tiled as j_solve_tiled
from lrs_pnp_dip_tpu.utils import config as jconfig
from lrs_pnp_dip_tpu_torch import inpaint_scene
from lrs_pnp_dip_tpu_torch.data import (
    TileLoader, bernoulli_mask, corrupt, mmap_cube, synthetic_sample, tile_origins,
)
from lrs_pnp_dip_tpu_torch.ops import mpsnr
from lrs_pnp_dip_tpu_torch.solvers import tiled as ttiled
from lrs_pnp_dip_tpu_torch.solvers.tiled import _tiled_engine, solve_tiled
from lrs_pnp_dip_tpu_torch.utils import config as tconfig

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)


def _scene(H=40, W=32, B=16):
    clean = synthetic_sample(height=H, width=W, bands=B, missing=0.0, seed=11).clean
    mask = bernoulli_mask((H, W), 0.92, seed=12)
    return clean, corrupt(clean, mask, noise_sigma=0.1, seed=13), mask


def _dictionary(patch_dim, n_atoms, seed):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((patch_dim, n_atoms)).astype(np.float32)
    return D / np.linalg.norm(D, axis=0, keepdims=True)


def _lrs_cfgs(block, **sparse):
    kw = dict(variant="lrs_pnp", outer_iters=2, block_size=block, stride=block, dip=None, mu1=0.15, mu2=0.9)
    return (tconfig.SolverConfig(sparse=tconfig.SparseProxConfig(**sparse), **kw),
            jconfig.SolverConfig(sparse=jconfig.SparseProxConfig(**sparse), **kw))


@pytest.mark.parametrize(
    "args", [(100, 90, 36, 36, None, None), (50, 40, 16, 16, 8, 8), (36, 36, 36, 36, None, None)],
    ids=["pulled_in", "strided", "one_tile"],
)
def test_tile_origins_cover_the_scene_and_match(args):
    h, w, th, tw = args[:4]
    o = tile_origins(*args)
    np.testing.assert_array_equal(o, j_tile_origins(*args))
    assert o.dtype == np.int32 and o[:, 0].max() == h - th and o[:, 1].max() == w - tw
    cov = np.zeros((h, w), bool)
    for h0, w0 in o:
        cov[h0 : h0 + th, w0 : w0 + tw] = True
    assert cov.all()


@pytest.mark.parametrize("stride", [None, (8, 8)], ids=["abutting", "overlapping"])
def test_tile_loader_roundtrip(stride, tmp_path):
    cube = np.random.default_rng(0).random((50, 40, 8)).astype(np.float32)
    loader = TileLoader(cube, (16, 16), batch_size=3, stride=stride)
    ref = JTileLoader(cube, (16, 16), batch_size=3, stride=stride, use_native=False)
    assert loader.n_tiles == ref.n_tiles
    seen = 0
    for (tiles, origins), (j_tiles, j_origins) in zip(loader, ref.batches()):
        assert tiles.shape[1:] == (16, 16, 8) and len(tiles) == len(origins) <= 3
        np.testing.assert_array_equal(origins, j_origins)
        np.testing.assert_array_equal(tiles, j_tiles)
        for t, (h0, w0) in zip(tiles, origins):
            np.testing.assert_array_equal(t, cube[h0 : h0 + 16, w0 : w0 + 16])
        seen += len(origins)
    assert seen == loader.n_tiles
    # a second pass starts a new prefetch thread and yields the same batches
    assert sum(len(o) for _, o in loader.batches()) == loader.n_tiles
    path = str(tmp_path / "cube.npy")
    np.save(path, cube)
    mapped = TileLoader(mmap_cube(path), (16, 16), batch_size=4)
    np.testing.assert_array_equal(next(iter(mapped))[0][0], cube[:16, :16])


@pytest.mark.parametrize("pad_final", [False, True], ids=["right_sized", "padded"])
@pytest.mark.parametrize("overlap", [0, 8])
def test_solve_tiled_lrs_pnp_matches_jax(overlap, pad_final):
    """6 tiles of 16x16 in batches of 4 (overlap 0) or 12 in batches of 5
    (overlap 8): the last batch is partial either way, with 2 tiles."""
    clean, noisy, mask = _scene()
    D = _dictionary(16 * 16, 48, seed=3)
    t_cfg, j_cfg = _lrs_cfgs(16, n_iter=8, alpha_mode="specnorm", h_scale=0.1)
    kw = dict(tile_shape=(16, 16), tile_batch=4 if overlap == 0 else 5, overlap=overlap, pad_final=pad_final)
    rec = solve_tiled(noisy, mask, D, t_cfg, device="cpu", **kw)
    ref = j_solve_tiled(noisy, mask, D, j_cfg, scan=False, **kw)
    assert rec.shape == noisy.shape and rec.dtype == np.float32
    np.testing.assert_allclose(rec, ref, rtol=2e-5, atol=2e-5)
    inp = float(mpsnr(torch.from_numpy(clean), torch.from_numpy(noisy)))
    assert float(mpsnr(torch.from_numpy(clean), torch.from_numpy(rec))) > inp
    # `scan` is accepted and changes nothing
    np.testing.assert_array_equal(solve_tiled(noisy, mask, D, t_cfg, device="cpu", scan=False, **kw), rec)


def test_solve_tiled_final_batch_is_right_sized_unless_padded(monkeypatch):
    """2 tiles with tile_batch 8: the batched constant build receives 2
    lanes by default, 8 with pad_final, the same scene either way."""
    clean, noisy, mask = _scene(H=32, W=16, B=8)
    D = _dictionary(64, 32, seed=4)
    cfg, _ = _lrs_cfgs(8, n_iter=4)
    sizes = []
    real_assemble = ttiled.assemble_consts

    def counting_assemble(noisy, mask_hw, D, config):
        sizes.append(len(noisy))
        return real_assemble(noisy, mask_hw, D, config)

    monkeypatch.setattr(ttiled, "assemble_consts", counting_assemble)
    rec = solve_tiled(noisy, mask, D, cfg, tile_shape=(16, 16), tile_batch=8, n_iters=1, device="cpu")
    rec_pad = solve_tiled(noisy, mask, D, cfg, tile_shape=(16, 16), tile_batch=8, n_iters=1,
                          pad_final=True, device="cpu")
    assert sizes == [2, 8]
    np.testing.assert_allclose(rec, rec_pad, rtol=1e-5, atol=1e-5)


def test_solve_tiled_dip_1lip_at_a_48_tile_is_finite():
    """`dip_1lip` composes with the tiled path at a tile size that takes the
    Lipschitz U-Net's nearest resizes (as ``tests/test_tiled.py``)."""
    clean, noisy, mask = _scene(H=48, W=48, B=8)
    cfg = tconfig.SolverConfig(
        variant="dip_1lip", outer_iters=1, block_size=8, stride=8, net_width=8,
        sparse=tconfig.SparseProxConfig(n_iter=2),
        dip=tconfig.DipConfig(num_iter=2, buffer_size=2, patience=5),
    )
    rec = solve_tiled(noisy, mask, _dictionary(64, 32, seed=5), cfg, tile_shape=(48, 48),
                      tile_batch=1, device="cpu")
    assert rec.shape == noisy.shape and np.isfinite(rec).all()


def test_tiled_engine_is_cached_and_seeds_tiles_by_position():
    cfg, _ = _lrs_cfgs(8, n_iter=2)
    cpu = torch.device("cpu")
    e1 = _tiled_engine(cfg, (16, 16, 8), None, cpu)
    assert _tiled_engine(cfg, (16, 16, 8), None, cpu) is e1
    assert _tiled_engine(cfg, (24, 16, 8), None, cpu) is not e1
    # a DIP engine keeps its net: the second scene solve builds none
    dip_cfg = tconfig.SolverConfig(
        variant="dip_1lip", block_size=8, stride=8, net_width=8, seed=3,
        sparse=tconfig.SparseProxConfig(n_iter=2), dip=tconfig.DipConfig(num_iter=1, buffer_size=2),
    )
    clean, noisy, mask = _scene(H=36, W=72, B=8)
    D = _dictionary(64, 32, seed=5)
    before = _tiled_engine.cache_info()
    first = solve_tiled(noisy, mask, D, dip_cfg, n_iters=1, tile_batch=2, device="cpu")
    second = solve_tiled(noisy, mask, D, dip_cfg, n_iters=1, tile_batch=2, device="cpu")
    after = _tiled_engine.cache_info()
    assert after.misses == before.misses + 1 and after.hits == before.hits + 1
    # tile i of a batch draws from a generator seeded config.seed + i: the
    # same call gives the same scene, and the two tiles get different nets
    np.testing.assert_array_equal(first, second)
    twin = np.concatenate([noisy[:, :36], noisy[:, :36]], axis=1)
    twin_mask = np.concatenate([mask[:, :36], mask[:, :36]], axis=1)
    rec = solve_tiled(twin, twin_mask, D, dip_cfg, n_iters=1, tile_batch=2, device="cpu")
    assert not np.allclose(rec[:, :36], rec[:, 36:], atol=1e-4)


def test_inpaint_scene_through_the_api():
    s = synthetic_sample(height=32, width=24, bands=16, missing=0.06, seed=23)
    cfg, j_cfg = _lrs_cfgs(8, n_iter=8, alpha_mode="specnorm", h_scale=0.1)
    D = _dictionary(64, 48, seed=6)
    cube = inpaint_scene(s.noisy, s.mask, config=cfg, dictionary=D, tile_shape=(16, 8),
                         tile_batch=2, device="cpu")
    assert cube.shape == s.noisy.shape
    ref = j_solve_tiled(s.noisy, s.mask, D, j_cfg, tile_shape=(16, 8), tile_batch=2)
    np.testing.assert_allclose(cube, ref, rtol=2e-5, atol=2e-5)
    inp = float(mpsnr(torch.from_numpy(s.clean), torch.from_numpy(s.noisy)))
    assert float(mpsnr(torch.from_numpy(s.clean), torch.from_numpy(cube))) > inp
    # the preset route: overrides build the config, `lrs_pnp` is the default variant
    same = inpaint_scene(s.noisy, s.mask, dictionary=D, tile_shape=(16, 8), tile_batch=2, device="cpu",
                         block_size=8, stride=8, sparse=cfg.sparse)
    np.testing.assert_array_equal(same, cube)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inpaint_scene(s.noisy, s.mask, config=cfg, dictionary=D, tile_shape=(16, 8))


def test_the_kept_engine_takes_a_dictionary_of_another_width():
    """The engine of one config and tile shape is kept across scenes; a scene
    whose dictionary has another width gets its own device-resident solve
    (the kept one refused the copy of its constants), and each width gives
    the bits of an engine built for it alone."""
    s = synthetic_sample(height=16, width=16, bands=8, missing=0.06, seed=4)
    cfg, _ = _lrs_cfgs(4, n_iter=4)
    tiles = dict(tile_shape=(8, 8), tile_batch=2, device="cpu")
    dicts = [_dictionary(16, k, seed=k) for k in (24, 20)]
    kept = [solve_tiled(s.noisy, s.mask, D, cfg, **tiles) for D in dicts + dicts[:1]]
    for D, rec in zip(dicts, kept):
        _tiled_engine.cache_clear()
        np.testing.assert_array_equal(rec, solve_tiled(s.noisy, s.mask, D, cfg, **tiles))
    np.testing.assert_array_equal(kept[2], kept[0])


def _numpy_stitch(shape, solved, th, tw):
    """The plain overlap average in numpy on the host, the device stitch's
    reference: ``solved`` is [(tiles, origins)] a batch, each tile added
    into a float64 sum in order, the sum divided by the count of tiles over
    each pixel (at least 1), rounded to float32."""
    h, w, b = shape
    out = np.zeros((h, w, b), np.float64)
    weight = np.zeros((h, w, 1), np.float64)
    for cubes, origins in solved:
        for cube, (h0, w0) in zip(cubes, origins):
            out[h0 : h0 + th, w0 : w0 + tw] += cube
            weight[h0 : h0 + th, w0 : w0 + tw] += 1.0
    return (out / np.maximum(weight, 1.0)).astype(np.float32)


def _record_solved_batches(monkeypatch, keep=None):
    """Record each batch's origins and solved state X as ``solve_tiled``
    runs, into the two lists returned; ``keep`` cuts each batch to its
    first ``keep`` tiles, so some pixels are covered by no tile."""
    origins, states = [], []
    batches, run = ttiled.TileLoader.batches, ttiled.ScannedSolve.run

    def recorded_batches(self):
        for tiles, o in batches(self):
            origins.append(o[:keep])
            yield tiles[:keep], o[:keep]

    def recorded_run(self, state, n, chunk=None):
        final, history = run(self, state, n, chunk)
        states.append(final.X.detach().cpu().numpy().copy())
        return final, history

    monkeypatch.setattr(ttiled.TileLoader, "batches", recorded_batches)
    monkeypatch.setattr(ttiled.ScannedSolve, "run", recorded_run)
    return origins, states


@pytest.mark.parametrize(
    "overlap, pad_final, keep",
    [(0, False, None), (0, True, None), (8, False, None), (8, True, None), (0, False, 1), (8, True, 2)],
    ids=["abutting", "abutting_padded", "overlapping", "overlapping_padded", "uncovered", "uncovered_padded"],
)
def test_device_stitch_equals_the_numpy_stitch_bit_for_bit(monkeypatch, overlap, pad_final, keep):
    """The scene's float64 sum and divide on the device give the bits of the
    host's numpy stitch of the same solved tiles: 6 tiles of 16x16 in
    batches of 4 (overlap 0) or 12 in batches of 5 (overlap 8), so the last
    batch is partial, right-sized or padded; with ``keep`` the loader
    yields only the first tiles of each batch, and the pixels no tile
    covers read 0.  The engine counts every tile placed and one readback a
    call, and two calls return arrays that share no memory."""
    clean, noisy, mask = _scene()
    D = _dictionary(16 * 16, 48, seed=3)
    cfg, _ = _lrs_cfgs(16, n_iter=4, alpha_mode="specnorm", h_scale=0.1)
    origins, states = _record_solved_batches(monkeypatch, keep)
    kw = dict(tile_shape=(16, 16), tile_batch=4 if overlap == 0 else 5, overlap=overlap, pad_final=pad_final)
    rec = solve_tiled(noisy, mask, D, cfg, n_iters=1, device="cpu", **kw)
    batches = [(X.reshape(-1, 16, 16, noisy.shape[2])[: len(o)], o) for X, o in zip(states, origins)]
    want = _numpy_stitch(noisy.shape, batches, 16, 16)
    assert rec.dtype == np.float32 and np.array_equal(rec, want)
    n_tiles, every = sum(len(o) for o in origins), 12 if overlap else 6
    assert n_tiles == every if keep is None else 0 < n_tiles < every
    if keep is not None:
        assert (rec == 0).all(axis=2).any()
    engine = _tiled_engine(cfg, (16, 16, noisy.shape[2]), None, torch.device("cpu"))
    assert (engine.placed, engine.readbacks) == (n_tiles, 1)
    again = solve_tiled(noisy, mask, D, cfg, n_iters=1, device="cpu", **kw)
    assert np.array_equal(again, rec) and not np.shares_memory(again, rec)
