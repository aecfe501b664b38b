"""Multi-process runtime bootstrap (counterpart of
``lrs_pnp_dip_tpu/parallel/distributed.py``).

A thin wrapper over ``torch.distributed.init_process_group`` that reads
torch's own variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``) or takes an ``init_method``, plus helpers to cut a host array to a
rank's piece and to gather a sharded tensor back.  The backend is always
gloo, on the card too: NCCL refuses two ranks on one GPU, which is how the
port's multi-rank paths run on a one-card machine.  :mod:`.launch` starts
the ranks of one machine (``python -m lrs_pnp_dip_tpu_torch.parallel.launch``).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import make_mesh, mesh_axis_sizes, mesh_device
from .sharding import Spec, shard, unshard


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: float = 600.0,
) -> None:
    """Start the gloo process group, once.  The arguments fall back to
    ``WORLD_SIZE`` / ``RANK`` and, for the rendezvous, ``env://`` when
    ``MASTER_ADDR`` is set; with neither an ``init_method`` nor more than
    one process this is a no-op, so one entry point serves both."""
    if dist.is_initialized():
        return
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None:
        if world_size not in (None, 1):
            raise ValueError(f"world size {world_size} needs an init_method or MASTER_ADDR")
        return  # single-process run
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def host_to_global(full: np.ndarray, spec: Spec, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's piece, on its device, of a host array that every rank
    holds whole: each rank takes only its own slice."""
    return shard(torch.as_tensor(np.asarray(full)), spec, mesh).to(mesh_device(mesh))


def fully_replicate(x: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> np.ndarray:
    """The whole of a sharded tensor as a host numpy array on every rank:
    one all_gather per split axis."""
    return unshard(x, spec, mesh).cpu().numpy()


def default_axes(n_ranks: int) -> Dict[str, int]:
    """The dryruns' mesh: 2-D {patch, band} whenever the rank count allows
    it, else ranks on patch."""
    if n_ranks % 2 == 0 and n_ranks > 1:
        return {"patch": n_ranks // 2, "band": 2}
    return {"patch": n_ranks}


def dryrun_problem():
    """The dryrun's problem (``lrs_pnp_dip_tpu/parallel/distributed.py:102-113``):
    a 36x36x128 synthetic cube, 36x36 blocks, a random K-128 dictionary and
    one `lrs_pnp` outer step with 4 ISTA iterations of the plain loop.
    Returns (sample, dictionary, config)."""
    from ..data import random_dictionary, synthetic_sample
    from ..utils.config import SolverConfig, SparseProxConfig

    sample = synthetic_sample(height=36, width=36, bands=128, missing=0.1, seed=0)
    D = random_dictionary(36 * 36, 128, seed=0)
    cfg = SolverConfig(
        variant="lrs_pnp", outer_iters=1, block_size=36, stride=36,
        sparse=SparseProxConfig(n_iter=4, backend="xla"), dip=None,
    )
    return sample, D, cfg


def dryrun_step(device: str = "cuda"):
    """One dryrun step over every rank on ``default_axes(world)`` and the
    same step on this rank alone: (sharded X whole, local X, mesh, MPSNR)."""
    from ..solvers import Solver
    from .engine import ShardedSolver

    initialize()
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh(default_axes(world), device)
    sample, D, cfg = dryrun_problem()
    sharded = ShardedSolver(sample, D, cfg, mesh, device=device)
    state, aux = sharded.step(sharded.init_state())
    X = sharded.gather(state.X).cpu().numpy()
    local = Solver(sample, D, cfg, device=mesh_device(mesh))
    st_local, _ = local.step(local.init_state())
    return X, st_local.X.cpu().numpy(), mesh, float(aux.mpsnr)


def multiprocess_dryrun(verbose: bool = True, device: str = "cuda") -> float:
    """Run one band+patch-sharded `lrs_pnp` step at the reference geometry
    over all ranks and hold it to a purely local step; returns the max
    |X_sharded - X_local|, which must be below 5e-4."""
    X, X_local, mesh, mpsnr = dryrun_step(device)
    if not np.isfinite(X).all():
        raise AssertionError("sharded step produced a non-finite state")
    diff = float(np.max(np.abs(X - X_local)))
    if verbose and is_primary():
        world = dist.get_world_size() if dist.is_initialized() else 1
        print(
            f"multiprocess_dryrun ok: processes={world}, device={mesh.device_type}, "
            f"mesh={mesh_axis_sizes(mesh)}, X={X.shape}, mpsnr={mpsnr:.3f}, "
            f"max|X_sharded-X_local|={diff:.2e}",
            flush=True,
        )
    if not diff < 5e-4:
        raise AssertionError(f"sharded step diverged from the local step by {diff}")
    return diff
