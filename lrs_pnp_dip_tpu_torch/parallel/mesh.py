"""Device-mesh construction (counterpart of ``lrs_pnp_dip_tpu/parallel/mesh.py``).

Axis convention, as in the JAX package:

  * ``data``  — independent recovery problems (lanes); each ``data`` group
    solves its own lanes;
  * ``patch`` — the block axis of the sparse prox and the pixel-row axis of
    the (P, B) iterate for the Gram all_reduce of the SVT;
  * ``band``  — the band columns of the iterate and the pixel columns of the
    blocks (and the dictionary's rows) in the 2-D sparse prox;
  * ``model`` — the output channels of the DIP net's convolutions (TP).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the ranks
of the default process group, with these axis names.  An axis the mesh does
not have counts as size 1 (:func:`axis_size`), so code written for a 2-D
mesh runs on a 1-D one.  :func:`axis_group` gives the process group of this
rank over any set of axes (``None`` when the set spans one rank, which the
collectives of :mod:`..utils.comm` read as "no peers").
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "patch", "band", "model")


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None, device_type: str = "cuda") -> DeviceMesh:
    """Build a DeviceMesh with named axes over every rank.

    ``make_mesh({"data": 2, "patch": 2})`` → a 2x2 mesh.  With no argument,
    all ranks go on ``patch``.  The mesh's size must equal the world size.
    Without a process group this initialises one (:func:`.distributed.initialize`
    from the environment, else a group of this one process), always gloo:
    NCCL refuses two ranks on one GPU, and ``init_device_mesh`` would pick it
    for ``"cuda"``.  On ``"cuda"`` each rank's device is ``rank % n_cards``,
    which ``init_device_mesh`` sets as the current device."""
    from .distributed import initialize

    initialize()
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"data": 1, "patch": world}
    unknown = [name for name in axis_sizes if name not in AXES]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; the axes are {AXES}")
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    n = 1
    for s in sizes:
        n *= s
    if n != world:
        raise ValueError(f"mesh {axis_sizes} needs {n} ranks, have {world}")
    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


def mesh_axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of axis ``name``, 1 when the mesh has no such axis."""
    return mesh_axis_sizes(mesh).get(name, 1)


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate on axis ``name`` (0 when there is none)."""
    if name not in mesh.mesh_dim_names:
        return 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(name)]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_group(mesh: DeviceMesh, names: Sequence[str]):
    """The process group of this rank over the axes ``names`` that the mesh
    has: the ranks that share this rank's coordinates on every other axis,
    ordered by their coordinates on ``names`` (row-major).  ``None`` when
    they are this rank alone.  The groups are made once per mesh, by every
    rank in the same order, at the first call for ``names``."""
    names = tuple(n for n in mesh.mesh_dim_names if n in names)
    if not names or all(axis_size(mesh, n) == 1 for n in names):
        return None
    if len(names) == 1:
        return mesh.get_group(names[0])
    cache = mesh.__dict__.setdefault("_axis_groups", {})
    if names not in cache:
        dims = [mesh.mesh_dim_names.index(n) for n in names]
        rest = [d for d in range(mesh.mesh.ndim) if d not in dims]
        width = 1
        for d in dims:
            width *= mesh.mesh.shape[d]
        rows = mesh.mesh.permute(*rest, *dims).reshape(-1, width).tolist()
        me = dist.get_rank()
        for ranks in rows:
            group = dist.new_group(ranks)
            if me in ranks:
                cache[names] = group
    return cache[names]


def group_root(mesh: DeviceMesh, names: Sequence[str]) -> int:
    """The global rank of the member of this rank's :func:`axis_group` over
    ``names`` that has coordinate 0 on each of them."""
    coord = list(mesh.get_coordinate())
    for i, n in enumerate(mesh.mesh_dim_names):
        if n in names:
            coord[i] = 0
    return int(mesh.mesh[tuple(coord)])
