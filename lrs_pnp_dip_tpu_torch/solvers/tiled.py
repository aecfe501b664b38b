"""Whole-scene recovery by tile streaming (counterpart of
``lrs_pnp_dip_tpu/solvers/tiled.py``).

Splits an arbitrarily large (H, W, B) scene into spatial tiles
(:mod:`..data.tiles`), solves each batch of tiles in lockstep through one
built step (:func:`.batch.lockstep_step`: one sparse prox, hence one
launch of kernel B1, per outer step over the blocks of every tile of the
batch), and stitches the recovered tiles back with overlap averaging.  The
tile feeder prefetches on a host thread while the device solves the
previous batch.  A batch's constants and initial state are built on the
device from one upload of its tiles and one of their masks
(:class:`_TileBatch`: one captured graph on the card, one power iteration
over the blocks of every tile).  With ``scan=True`` a batch's steps run on
the device (:class:`.scan.ScannedSolve`, CUDA graphs on the card), else from
the host; either way each DIP fit replays the engine's one captured
iteration (one capture per net and tile shape, whatever the batch).  The
stitch runs on the device too: each batch's tiles are added into a float64
sum of the scene as they are solved, and the host gets one copy of the
finished float32 scene a call.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.tiles import TileLoader
from ..utils.config import SolverConfig
from ..utils.device import resolve_device
from ..utils.profiling import annotate
from .admm import OuterStages, ProblemConsts, SolverState, assemble_consts
from .batch import lockstep_step
from .graphs import Captured
from .scan import ScannedSolve


class _TileBatch:
    """One batch shape's constants and initial state, built on the device.

    Two uploads per batch fill static buffers: the loader's stacked tiles
    and their stacked masks.  The build reads them and the engine's
    dictionary buffer, and writes the stacked :class:`.admm.ProblemConsts`
    (:func:`.admm.assemble_consts`: one power iteration over the blocks of
    every tile) and the state X = Y with zero duals into tensors it keeps:
    the first build's, refilled in place by every later one.  On the card
    the build is a :class:`.graphs.Captured`, so a batch after the second
    replays one graph and launches no kernel from the host; on the CPU it
    runs eagerly.  The batch's device-resident solve reads the kept
    constants as its own, so loading a batch copies nothing more."""

    def __init__(self, stages: OuterStages, lanes: int, D: torch.Tensor):
        th, tw, b = stages.image_shape
        self.stages = stages
        self.device = stages.device
        self.tiles = torch.empty((lanes, th, tw, b), dtype=torch.float32, device=self.device)
        self.masks = torch.empty((lanes, th, tw), dtype=torch.float32, device=self.device)
        self.D = D
        self.consts: Optional[ProblemConsts] = None
        self.state = None  # (X, lambda1, lambda2)
        self.captured = Captured(self._assemble, self.device)
        self._scan = None

    def _assemble(self) -> None:
        consts = assemble_consts(self.tiles, self.masks, self.D, self.stages.config)
        if self.consts is None:
            self.consts = consts
            self.state = tuple(torch.empty_like(consts.Y) for _ in range(3))
        else:
            for kept, new in zip(self.consts, consts):
                kept.copy_(new)  # no copy where both view the same buffer
        X, lambda1, lambda2 = self.state
        X.copy_(consts.Y)
        lambda1.zero_()
        lambda2.zero_()

    def build(self, tiles: np.ndarray, masks: np.ndarray, seed: int):
        """(consts, state) of ``tiles`` (lanes, th, tw, B) and ``masks``
        (lanes, th, tw), both f32; lane i draws from a generator seeded
        ``seed + i``.  Overwrites the previous batch's: the caller has added
        that batch into its scene first, and the device's stream runs that
        add before this refill."""
        self.tiles.copy_(torch.from_numpy(tiles))
        self.masks.copy_(torch.from_numpy(masks))
        self.captured()
        generators = tuple(torch.Generator(device=self.device).manual_seed(seed + i) for i in range(len(tiles)))
        return self.consts, SolverState(*self.state, generator=generators, itr=0)

    def scanned(self) -> ScannedSolve:
        """The device-resident solve of this batch shape, on the kept constants."""
        if self._scan is None:
            self._scan = ScannedSolve(self.stages, self.consts, lanes=True)
        return self._scan


class _TileEngine:
    """The stages of one (config, tile shape, net, device), their lockstep
    step, which takes any number of lanes, a dictionary buffer per
    dictionary shape, and a :class:`_TileBatch` per batch shape: its number
    of lanes (a final partial batch has its own) and the dictionary's width
    (two scenes may bring two).  Counters of the latest :func:`solve_tiled`
    call: ``placed``, the tiles added into the scene's sum on the device,
    and ``readbacks``, the copies of the scene to the host."""

    def __init__(self, config: SolverConfig, tile3, net, device: torch.device):
        self.stages = OuterStages(config, tile3, net=net, device=device)
        self.step = lockstep_step(self.stages)
        self._dictionaries = {}
        self._batches = {}
        self.placed = 0
        self.readbacks = 0

    def dictionary(self, dictionary) -> torch.Tensor:
        """``dictionary`` on the device: one upload into the buffer of its
        shape, made on every call (a caller may change its array in place)."""
        host = torch.as_tensor(np.asarray(dictionary, np.float32))
        if host.shape not in self._dictionaries:
            self._dictionaries[host.shape] = torch.empty(host.shape, dtype=torch.float32, device=self.stages.device)
        return self._dictionaries[host.shape].copy_(host)

    def to_host(self, scene: torch.Tensor) -> np.ndarray:
        """``scene`` as a fresh host array that the caller owns: from the
        card, one copy into new pageable memory (faster a call than a
        page-locked buffer and a host copy,
        ``scripts/time_stitch_readback.py``); on the CPU, the tensor's own
        memory."""
        self.readbacks += 1
        return scene.cpu().numpy()

    def batch(self, lanes: int, D: torch.Tensor) -> _TileBatch:
        key = (lanes, *D.shape)
        if key not in self._batches:
            self._batches[key] = _TileBatch(self.stages, lanes, D)
        return self._batches[key]


@functools.lru_cache(maxsize=16)
def _tiled_engine(config: SolverConfig, tile3, net, device: torch.device) -> _TileEngine:
    """The engine of one (config, tile shape, net, device), kept across
    :func:`solve_tiled` calls: a second scene solve builds no new net and,
    on the card, captures no new graph."""
    return _TileEngine(config, tile3, net, device)


def solve_tiled(
    noisy: np.ndarray,  # (H, W, B) observed scene (missing pixels = 0)
    mask: np.ndarray,  # (H, W) observation mask
    dictionary: np.ndarray,
    config: SolverConfig,
    tile_shape: Tuple[int, int] = (36, 36),
    tile_batch: int = 8,
    overlap: int = 0,
    n_iters: Optional[int] = None,
    net=None,
    verbose: bool = False,
    scan: bool = True,
    pad_final: bool = False,
    device="cuda",
) -> np.ndarray:
    """Recover the whole scene tile by tile; returns (H, W, B).

    ``overlap`` > 0 strides tiles by (tile - overlap) and averages the
    overlapping recoveries (seam suppression).  Tile i of a batch is seeded
    with ``config.seed + i``.

    ``scan=True`` (default) runs a batch's ``n`` outer steps on the device
    (:class:`.scan.ScannedSolve`: captured graphs on the card, the step
    history read back once per batch); ``scan=False`` steps each batch's
    outer loop from the host, its DIP fits replayed as in ``scan=True``.
    Both give the same bits on the CPU.

    A final partial batch runs at its real size by default; ``pad_final=True``
    pads it to ``tile_batch`` by duplicating its last tile (the extras are
    dropped), which here only costs the wasted lanes: the built step serves
    any batch size.

    The stitch keeps the scene's float64 sum and weight on ``device`` and
    returns a fresh float32 array, copied to the host once.

    Runs on ``device``: the card by default, which raises when there is none.
    """
    device = resolve_device(device)
    h, w, b = noisy.shape
    th, tw = tile_shape
    stride = (th - overlap, tw - overlap) if overlap else None
    loader = TileLoader(
        np.ascontiguousarray(noisy, np.float32), (th, tw),
        batch_size=tile_batch, stride=stride,
    )
    n = config.outer_iters if n_iters is None else n_iters
    engine = _tiled_engine(config, (th, tw, b), net, device)

    with annotate("tiles.consts"):
        D = engine.dictionary(dictionary)
        mask = np.asarray(mask, np.float32)
    # the overlap average, in float64 on the device: each tile added into
    # the sum in the loader's order, uncovered pixels divided by 1
    out = torch.zeros((h, w, b), dtype=torch.float64, device=device)
    weight = torch.zeros((h, w, 1), dtype=torch.float64, device=device)
    engine.placed = engine.readbacks = 0

    for tiles, origins in loader.batches():
        n_real = len(origins)
        with annotate("tiles.consts"):
            masks = np.stack([mask[h0 : h0 + th, w0 : w0 + tw] for h0, w0 in origins])
            if pad_final and n_real < tile_batch:
                extra = tile_batch - n_real
                tiles = np.concatenate([tiles, np.repeat(tiles[-1:], extra, axis=0)])
                masks = np.concatenate([masks, np.repeat(masks[-1:], extra, axis=0)])
            batch = engine.batch(len(tiles), D)
            # refills the buffers the previous batch of this shape was solved
            # on: safe, since the stream runs that batch's adds below first
            consts, state = batch.build(tiles, masks, config.seed)
        if scan:
            state, _ = batch.scanned().run(state, n)
        else:
            for _ in range(n):
                state, _ = engine.step(state, consts)
        with annotate("tiles.stitch"):
            for cube, (h0, w0) in zip(state.X.detach().reshape(-1, th, tw, b)[:n_real], origins):
                out[h0 : h0 + th, w0 : w0 + tw].add_(cube)
                weight[h0 : h0 + th, w0 : w0 + tw].add_(1.0)
            engine.placed += n_real
        if verbose:
            print(f"solved {n_real} tiles at origin {tuple(origins[0])}", flush=True)

    with annotate("tiles.stitch"):
        scene = (out / weight.clamp_min(1.0)).to(torch.float32)
    with annotate("tiles.readback"):
        return engine.to_host(scene)
