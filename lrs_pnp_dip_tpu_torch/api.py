"""One-call user API (counterpart of ``lrs_pnp_dip_tpu/api.py``).

    from lrs_pnp_dip_tpu_torch import inpaint, inpaint_scene
    cube, info = inpaint(noisy, mask, variant="dip")          # on the card
    cube, info = inpaint(noisy, mask, variant="dip", device="cpu")
    cube, info = inpaint(noisy, mask, variant="dip_tuned", seeds=[0, 1, 2])
    scene = inpaint_scene(noisy, mask, variant="lrs_pnp", tile_batch=8)

Every preset runs.  Without a dictionary, the shipped 36x36 dictionary is
used when the patch geometry matches; learning one is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .data.dictionary import load_trained_dictionary
from .data.io import HsiSample
from .utils.config import PRESETS, SolverConfig


def _auto_dictionary(config: SolverConfig, n_atoms: int = 512) -> np.ndarray:
    if config.block_size != 36:
        raise NotImplementedError(
            "learning a dictionary for block_size != 36 is not ported yet "
            "(ROADMAP Queue A, item 14); pass dictionary="
        )
    return load_trained_dictionary(n_atoms)


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

    ``seeds``: run a seed ensemble instead of a single solve.  The DIP
    variants are stochastic (a fresh net per outer iteration), and the mean
    of N independent draws is a stronger estimator than any single run.  The
    returned cube is the ensemble mean at the final iteration; ``history``
    carries per-seed ``mpsnr`` (n_iters, n_seeds) and the ensemble's
    ``ens_mpsnr`` (n_iters,).

    Runs on ``device``: the card by default, which raises when there is
    none; pass ``device='cpu'`` for the plain PyTorch path."""
    from .solvers import SeedEnsembleSolver, Solver

    sample = HsiSample(
        noisy=np.asarray(noisy, np.float32),
        mask=np.asarray(mask, np.float32),
        clean=None if clean is None else np.asarray(clean, np.float32),
    )
    cfg = config or PRESETS[variant](**preset_overrides)
    if dictionary is None:
        dictionary = _auto_dictionary(cfg)
    if seeds is not None:
        ens = SeedEnsembleSolver(sample, dictionary, cfg, seeds, device=device)
        state, hist = ens.run_chunked(n_iters)
        cube = state.X.mean(dim=0).reshape(sample.shape).cpu().numpy()
        return cube, hist
    solver = Solver(sample, dictionary, cfg, device=device)
    state, hist = solver.run(n_iters=n_iters)
    return solver.result_cube(state), hist


def inpaint_scene(
    noisy: np.ndarray,
    mask: np.ndarray,
    variant: str = "lrs_pnp",
    dictionary: Optional[np.ndarray] = None,
    config: Optional[SolverConfig] = None,
    tile_shape: Tuple[int, int] = (36, 36),
    tile_batch: int = 8,
    overlap: int = 0,
    n_iters: Optional[int] = None,
    net=None,
    verbose: bool = False,
    scan: Optional[bool] = None,
    pad_final: bool = False,
    device="cuda",
    **preset_overrides,
) -> np.ndarray:
    """Recover an arbitrarily large (H, W, B) scene by tile streaming: the
    whole-scene counterpart of :func:`inpaint`.  Splits the scene into
    ``tile_shape`` tiles, solves ``tile_batch`` of them in lockstep
    (:func:`.solvers.tiled.solve_tiled`) and stitches with overlap
    averaging.  The dictionary is handled as in :func:`inpaint`.  Returns the
    recovered (H, W, B) cube.

    ``scan`` is accepted for the JAX package's signature and changes
    nothing: the port steps every batch from the host.  ``net``,
    ``verbose`` and ``pad_final`` go to ``solve_tiled``."""
    from .solvers.tiled import solve_tiled

    cfg = config or PRESETS[variant](**preset_overrides)
    if dictionary is None:
        dictionary = _auto_dictionary(cfg)
    return solve_tiled(
        np.asarray(noisy, np.float32), np.asarray(mask, np.float32), dictionary, cfg,
        tile_shape=tile_shape, tile_batch=tile_batch, overlap=overlap, n_iters=n_iters,
        net=net, verbose=verbose, scan=bool(scan), pad_final=pad_final, device=device,
    )
