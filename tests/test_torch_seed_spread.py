"""The `dip` solve in distribution over seeds, with no weight transplant:
the port through ``inpaint(seeds=...)`` against the JAX package's
``SeedEnsembleSolver``.

The two packages draw their DIP inits from different generators, and Adam
parts the fits within a few iterations, so the solves are compared as
distributions: the mean final MPSNR over the seeds must agree within the
seed spread.  Size: a 16x16x16 synthetic cube (seed 21), block 8, a random
64x32 dictionary (seed 6), the `dip` variant's skip-128 net, 2 outer steps
of 5 ISTA iterations and DIP fits of at most 15 Adam steps at lr 0.05
(window 5, patience 30); seeds 0 to 3.  Limit: |mean_port - mean_jax| is
at most the larger of the two packages' seed ranges (max - min of the
final MPSNR over the seeds), each of which must be above zero.
"""

import numpy as np
import torch

from lrs_pnp_dip_tpu.data import random_dictionary as j_random_dictionary
from lrs_pnp_dip_tpu.data.masks import synthetic_sample as j_synthetic_sample
from lrs_pnp_dip_tpu.solvers import SeedEnsembleSolver as JSeedEnsembleSolver
from lrs_pnp_dip_tpu.utils import config as jconfig
from lrs_pnp_dip_tpu_torch import inpaint
from lrs_pnp_dip_tpu_torch.data import random_dictionary, synthetic_sample
from lrs_pnp_dip_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

SEEDS = [0, 1, 2, 3]
SOLVE = dict(variant="dip", outer_iters=2, block_size=8, stride=8)
SPARSE = dict(n_iter=5)
DIP = dict(num_iter=15, learning_rate=0.05, buffer_size=5, patience=30)


def test_dip_seed_ensemble_matches_jax_in_distribution():
    cfg = tconfig.SolverConfig(
        sparse=tconfig.SparseProxConfig(**SPARSE), dip=tconfig.DipConfig(**DIP), **SOLVE
    )
    s = synthetic_sample(16, 16, 16, missing=0.1, seed=21)
    cube, hist = inpaint(s.noisy, s.mask, clean=s.clean, dictionary=random_dictionary(64, 32, seed=6),
                         config=cfg, seeds=SEEDS, device="cpu")
    ours = np.asarray(hist["mpsnr"])[-1]

    j_cfg = jconfig.SolverConfig(
        sparse=jconfig.SparseProxConfig(**SPARSE), dip=jconfig.DipConfig(**DIP), **SOLVE
    )
    ens = JSeedEnsembleSolver(j_synthetic_sample(height=16, width=16, bands=16, missing=0.1, seed=21),
                              j_random_dictionary(64, 32, seed=6), j_cfg, SEEDS)
    _, j_hist = ens.run(2)
    ref = np.asarray(j_hist["mpsnr"])[-1]

    assert cube.shape == (16, 16, 16) and np.isfinite(cube).all()
    assert ours.shape == ref.shape == (len(SEEDS),)
    spreads = [float(np.ptp(ours)), float(np.ptp(ref))]
    assert min(spreads) > 0, spreads
    gap = abs(float(np.mean(ours)) - float(np.mean(ref)))
    assert gap <= max(spreads), (gap, spreads, ours, ref)
