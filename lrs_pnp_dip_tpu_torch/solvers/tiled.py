"""Whole-scene recovery by tile streaming (counterpart of
``lrs_pnp_dip_tpu/solvers/tiled.py``).

Splits an arbitrarily large (H, W, B) scene into spatial tiles
(:mod:`..data.tiles`), solves each batch of tiles in lockstep through one
built step (:func:`.batch.lockstep_step`: one sparse prox, hence one
launch of kernel B1, per outer step over the blocks of every tile of the
batch), and stitches the recovered tiles back with overlap averaging.  The
tile feeder prefetches on a host thread while the device solves the
previous batch.  With ``scan=True`` a batch's steps run on the device
(:class:`.scan.ScannedSolve`, CUDA graphs on the card), else from the host;
either way each DIP fit replays the engine's one captured iteration (one
capture per net and tile shape, whatever the batch).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.io import HsiSample
from ..data.tiles import TileLoader
from ..utils.config import SolverConfig
from ..utils.device import resolve_device
from ..utils.profiling import annotate
from .admm import OuterStages, init_state, make_consts
from .batch import lockstep_step, stack_consts, stack_states
from .scan import ScannedSolve


class _TileEngine:
    """The stages of one (config, tile shape, net, device), their lockstep
    step, which takes any number of lanes, and a device-resident solve per
    shape of the batch's constants: its size (a final partial batch has its
    own) and the dictionary's width (two scenes may bring two)."""

    def __init__(self, config: SolverConfig, tile3, net, device: torch.device):
        self.stages = OuterStages(config, tile3, net=net, device=device)
        self.step = lockstep_step(self.stages)
        self._scans = {}

    def scanned(self, consts) -> ScannedSolve:
        key = tuple(tuple(t.shape) for t in consts)
        if key not in self._scans:
            self._scans[key] = ScannedSolve(self.stages, consts, lanes=True)
        else:
            self._scans[key].set_consts(consts)
        return self._scans[key]


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
    (:class:`.scan.ScannedSolve`: captured graphs on the card, the state
    read back once per batch); ``scan=False`` steps each batch's outer loop
    from the host, its DIP fits replayed as in ``scan=True``.  Both give the
    same bits on the CPU.

    A final partial batch runs at its real size by default; ``pad_final=True``
    pads it to ``tile_batch`` by duplicating its last tile (the extras are
    dropped), which here only costs the wasted lanes: the built step serves
    any batch size.

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

    out = np.zeros((h, w, b), np.float64)
    weight = np.zeros((h, w, 1), np.float64)

    for tiles, origins in loader.batches():
        n_real = len(origins)
        samples = [
            HsiSample(noisy=t, mask=mask[h0 : h0 + th, w0 : w0 + tw])
            for t, (h0, w0) in zip(tiles, origins)
        ]
        if pad_final:
            while len(samples) < tile_batch:
                samples.append(samples[-1])
        with annotate("tiles.consts"):
            consts_list = [make_consts(s, dictionary, config, device=device) for s in samples]
            consts = stack_consts(consts_list)
            # X starts at the observed image, already on the device in consts.Y
            state = stack_states(
                [init_state(c.Y, config.seed + i, device=device) for i, c in enumerate(consts_list)]
            )
        if scan:
            state, _ = engine.scanned(consts).run(state, n)
        else:
            for _ in range(n):
                state, _ = engine.step(state, consts)
        with annotate("tiles.readback"):
            cubes = state.X.detach().cpu().numpy().reshape(-1, th, tw, b)[:n_real]
        with annotate("tiles.stitch"):
            for cube, (h0, w0) in zip(cubes, origins):
                out[h0 : h0 + th, w0 : w0 + tw] += cube
                weight[h0 : h0 + th, w0 : w0 + tw] += 1.0
        if verbose:
            print(f"solved {n_real} tiles at origin {tuple(origins[0])}", flush=True)

    with annotate("tiles.stitch"):
        return (out / np.maximum(weight, 1.0)).astype(np.float32)
