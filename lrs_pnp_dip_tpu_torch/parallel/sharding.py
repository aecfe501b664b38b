"""Placement of the solver's tensors on a mesh (counterpart of
``lrs_pnp_dip_tpu/parallel/sharding.py``).

GSPMD has no torch counterpart, so a placement here is a *spec*: a tuple
with one entry per tensor dimension, the mesh axis that dimension is split
over or ``None`` (a dimension past the spec's end is whole).  :func:`shard`
cuts a whole tensor to this rank's piece, :func:`unshard` gathers the
pieces back with one all_gather per split dimension.  A split must be even,
as a ``NamedSharding`` must be in the JAX package.

The rules are the JAX package's:

  * the iterate and the duals ``(P, B)``: rows over ``patch``, columns over
    ``band`` when the mesh has one;
  * blocks, ``mask_blocks`` ``(nB, bb*bb)`` and ``alpha`` ``(nB,)``: the
    block axis over ``patch``;
  * the dictionary: whole on every rank;
  * with a leading sample axis, that axis over ``data``.

The engine (:mod:`.engine`) holds the state by these rules between steps;
it keeps the constants whole within a ``data`` group, where every rank
makes them once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..solvers.admm import ProblemConsts, SolverState, StepAux
from ..utils.comm import all_gather
from .mesh import axis_group, axis_index, axis_size

Spec = Tuple[Optional[str], ...]


def replicate(mesh: DeviceMesh) -> Spec:
    """Whole on every rank."""
    return ()


def _band(mesh: DeviceMesh) -> Optional[str]:
    """The axis of the band columns of (P, B) matrices: ``band`` when the
    mesh has one (the 2-D {patch, band} layout), else none."""
    return "band" if "band" in mesh.mesh_dim_names else None


def state_sharding(mesh: DeviceMesh, batched: bool = False) -> SolverState:
    """Specs of the SolverState fields.  ``batched`` adds a leading data axis."""
    lead = ("data",) if batched else ()
    mat = (*lead, "patch", _band(mesh))
    rep = lead
    return SolverState(X=mat, lambda1=mat, lambda2=mat, generator=rep, itr=())


def consts_sharding(mesh: DeviceMesh, batched: bool = False) -> ProblemConsts:
    lead = ("data",) if batched else ()
    mat = (*lead, "patch", _band(mesh))
    blocks = (*lead, "patch")
    return ProblemConsts(
        Y=mat, mask2d=mat, mask_blocks=blocks, D=replicate(mesh),
        clean=lead, dip_target=lead, dip_mask=lead, alpha=blocks,
    )


def aux_sharding(mesh: DeviceMesh, batched: bool = False) -> StepAux:
    lead = ("data",) if batched else ()
    mat = (*lead, "patch", _band(mesh))
    return StepAux(
        mpsnr=lead, ssim=lead, x_dist=lead, l1_dist=lead, l2_dist=lead,
        dip_iters=lead, dip_loss=lead, U=mat, phi_scatter=mat,
    )


def _splits(t: torch.Tensor, spec: Spec, mesh: DeviceMesh):
    """(dim, axis) for every dimension of ``t`` that ``spec`` splits over an
    axis of the mesh with more than one rank."""
    return [
        (dim, name) for dim, name in enumerate(spec)
        if name is not None and axis_size(mesh, name) > 1
    ]


def shard(t: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's piece of the whole tensor ``t`` (a view where it can be)."""
    for dim, name in _splits(t, spec, mesh):
        n = axis_size(mesh, name)
        if t.shape[dim] % n:
            raise ValueError(
                f"dimension {dim} of a {tuple(t.shape)} tensor does not split "
                f"evenly over {name}={n}"
            )
        width = t.shape[dim] // n
        t = t.narrow(dim, axis_index(mesh, name) * width, width)
    return t


def unshard(t: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> torch.Tensor:
    """The whole tensor from this rank's piece ``t``, on every rank."""
    for dim, name in _splits(t, spec, mesh):
        t = all_gather(t, axis_group(mesh, (name,)), dim)
    return t


def within_data_group(spec: Spec) -> Spec:
    """``spec`` without its ``data`` entry: the placement inside one data
    group, whose ranks hold the same lanes."""
    return tuple(None if name == "data" else name for name in spec)
