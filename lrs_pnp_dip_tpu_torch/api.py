"""One-call user API (counterpart of ``lrs_pnp_dip_tpu/api.py``).

    from lrs_pnp_dip_tpu_torch import inpaint, inpaint_scene
    cube, info = inpaint(noisy, mask, variant="dip")          # on the card
    cube, info = inpaint(noisy, mask, variant="dip", device="cpu")
    cube, info = inpaint(noisy, mask, variant="dip_tuned", seeds=[0, 1, 2])
    scene = inpaint_scene(noisy, mask, variant="lrs_pnp", tile_batch=8)

Every preset runs.  Dictionary acquisition is automatic: the shipped
artifact when the patch geometry matches, otherwise a dictionary learned on
the fly from the observed data (masked entries excluded), on the solve's
device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .data.dictionary import extract_training_patches, learn_dictionary, load_trained_dictionary
from .data.io import HsiSample
from .utils.config import PRESETS, SolverConfig


def _auto_dictionary(
    sample: HsiSample, config: SolverConfig, n_atoms: int = 512, device="cuda"
) -> np.ndarray:
    if config.block_size * config.block_size == 36 * 36:
        try:
            return load_trained_dictionary(n_atoms)
        except FileNotFoundError:
            pass
    # learn from the observed image itself, the noisy cube being all there
    # is.  Masked entries are excluded: fully-observed patches when enough
    # exist, otherwise mask-aware learning (holes carry zero weight), so
    # zero-filled holes never train into atoms.
    patches, mask_patches = extract_training_patches(
        [sample.noisy], block_size=config.block_size, stride=1, masks=[sample.mask],
    )
    fully_observed = mask_patches.min(axis=0) > 0
    n_full = int(fully_observed.sum())
    if n_full >= max(64, patches.shape[1] // 4):
        patches = patches[:, fully_observed]
        mask_patches = None
    n_atoms = min(n_atoms, max(64, patches.shape[1] // 2))
    return learn_dictionary(
        patches, n_atoms=n_atoms, n_outer=10, sparse_iters=20,
        mask_patches=mask_patches, device=device,
    )


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
    ``ens_mpsnr`` (n_iters,).  The ensemble runs on the device
    (``SeedEnsembleSolver.run_chunked``: 25 outer steps per host read).
    Without ``seeds`` the host steps the outer loop (``Solver.run``) and
    each DIP fit runs on the device, its captured iteration replayed 8
    times per read of the stop flag.

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
        dictionary = _auto_dictionary(sample, cfg, device=device)
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
    averaging.  The dictionary is handled as in :func:`inpaint`, learned
    from a central crop of at most 128 x 128 pixels.  Returns the recovered
    (H, W, B) cube.

    ``scan``: ``None`` (default) takes the device-resident loop for
    ``lrs_pnp`` and the host-stepped outer loop for the DIP variants, as the
    JAX package chooses (each DIP fit replays its captured iteration either
    way); ``True`` / ``False`` force either.  ``net``,
    ``verbose`` and ``pad_final`` go to ``solve_tiled``."""
    from .solvers.tiled import solve_tiled

    noisy = np.asarray(noisy, np.float32)
    mask = np.asarray(mask, np.float32)
    cfg = config or PRESETS[variant](**preset_overrides)
    if dictionary is None:
        # the dictionary's geometry is cfg.block_size, whatever the tile size
        h, w = noisy.shape[:2]
        ch, cw = min(h, 128), min(w, 128)
        h0, w0 = (h - ch) // 2, (w - cw) // 2
        probe = HsiSample(
            noisy=noisy[h0 : h0 + ch, w0 : w0 + cw], mask=mask[h0 : h0 + ch, w0 : w0 + cw],
        )
        dictionary = _auto_dictionary(probe, cfg, device=device)
    if scan is None:
        scan = cfg.variant == "lrs_pnp"
    return solve_tiled(
        noisy, mask, dictionary, cfg,
        tile_shape=tile_shape, tile_batch=tile_batch, overlap=overlap, n_iters=n_iters,
        net=net, verbose=verbose, scan=scan, pad_final=pad_final, device=device,
    )
