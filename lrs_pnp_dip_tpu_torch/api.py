"""One-call user API (counterpart of ``lrs_pnp_dip_tpu/api.py:inpaint``).

    from lrs_pnp_dip_tpu_torch import inpaint
    cube, info = inpaint(noisy, mask, variant="dip")          # on the card
    cube, info = inpaint(noisy, mask, variant="dip", device="cpu")

Only single-seed ``variant='dip'`` solves are ported.  Without a
dictionary, the shipped 36x36 dictionary is used when the patch geometry
matches.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .data.dictionary import load_trained_dictionary
from .data.io import HsiSample
from .utils.config import PRESETS, SolverConfig


def inpaint(
    noisy: np.ndarray,
    mask: np.ndarray,
    variant: str = "dip",
    clean: Optional[np.ndarray] = None,
    dictionary: Optional[np.ndarray] = None,
    config: Optional[SolverConfig] = None,
    n_iters: Optional[int] = None,
    seeds: Optional[Sequence[int]] = None,
    device="cuda",
    **preset_overrides,
) -> Tuple[np.ndarray, dict]:
    """Recover a masked+noisy (H, W, B) cube.  Returns (cube, history).

    Runs on ``device``: the card by default, which raises when there is
    none; pass ``device='cpu'`` for the plain PyTorch path."""
    from .solvers import Solver

    if seeds is not None:
        raise NotImplementedError(
            "seed ensembles (seeds=...) are not ported yet (ROADMAP Queue A, item 11)"
        )
    sample = HsiSample(
        noisy=np.asarray(noisy, np.float32),
        mask=np.asarray(mask, np.float32),
        clean=None if clean is None else np.asarray(clean, np.float32),
    )
    cfg = config or PRESETS[variant](**preset_overrides)
    if dictionary is None:
        if cfg.block_size != 36:
            raise NotImplementedError(
                "learning a dictionary for block_size != 36 is not ported yet "
                "(ROADMAP Queue A, item 14); pass dictionary="
            )
        dictionary = load_trained_dictionary(512)
    solver = Solver(sample, dictionary, cfg, device=device)
    state, hist = solver.run(n_iters=n_iters)
    return solver.result_cube(state), hist


def inpaint_scene(*args, **kwargs):
    """Tile-streamed whole-scene recovery: not ported yet."""
    raise NotImplementedError(
        "inpaint_scene (tiled scenes) is not ported yet (ROADMAP Queue A, item 12)"
    )
