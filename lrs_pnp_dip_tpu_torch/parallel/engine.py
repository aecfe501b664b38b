"""Mesh-sharded solver engine (counterpart of ``lrs_pnp_dip_tpu/parallel/engine.py``).

The same outer step as :mod:`..solvers.admm` (one problem) or
:mod:`..solvers.batch` (lanes), with the stages that have cross-rank
structure replaced through the step builders' hooks, chosen from the mesh
axes as the JAX engine chooses them:

  * ``patch``: the sparse prox over the ranks' shares of the blocks
    (:func:`.collectives.make_sharded_sparse_prox`, one launch of kernel B1
    per rank per step on the card) and, for ``lrs_pnp``, the Gram
    all_reduce SVT (:func:`.collectives.make_distributed_svt`);
  * ``patch`` and ``band``: the 2-D sparse prox and the 2-D SVT
    (the plain loop with an all_reduce per ISTA iteration; no B1 launch);
  * ``model`` with ``dip`` or ``dip_1lip``: channel TP of the DIP net
    (:class:`.tensor.ChannelParallel`);
  * ``data``: the lanes of a batch, lane i seeded with ``seed + i``; each
    ``data`` group runs the lockstep step (:func:`..solvers.batch.lockstep_step`)
    on its own lanes, and each lane trains its own net, so no gradient
    crosses groups.

Between steps each rank holds its shard of the state (:func:`.sharding.state_sharding`).
Inside a step the block extraction, the scatter and the data-fidelity update
straddle shards, so the step gathers the state whole within the rank's
``data`` group (one all_gather per split axis of the stacked X, lambda1,
lambda2), runs the stages on whole tensors, each rank computing the same
values, and keeps its shard of the new state.  Per step and rank that moves
(for a ``(P, B)`` iterate of f32 over ``n`` ranks of ``patch`` x ``band``):
``3 P B 4 (n-1)/n`` bytes for the state, ``nB K 4 (n-1)/n`` for the
sparse prox's coefficients (1-D), and for ``lrs_pnp`` ``4 B^2`` for the Gram
plus ``P B 4 (n-1)/n`` for the SVT's rows (``utils.comm.TRAFFIC`` counts
them; the 2-D prox adds an all_reduce of its (nB/p, K) partial gradient per
ISTA iteration).
The constants are made whole on every rank of a ``data`` group, once.

The DIP fit is not split over ``patch`` or ``band``: GSPMD's spatial
partition of a 36x36 conv has no counterpart here, and it changes no
result.  The fit runs on the rank with coordinate 0 on those axes (with
its ``model`` group under TP) and its output is broadcast over them, so
every rank holds the same bits of U.  There, as in one process, it replays
its captured iteration ``FIT_CHUNK`` times per read of the stop flag.  The
mesh's ``model`` axis is the one exception: a channel-TP net runs gloo
collectives inside its forward and backward, on CUDA tensors through the
host (:mod:`..utils.comm`), which a CUDA graph cannot capture, and NCCL,
which could be captured, cannot put two ranks on one card.  So its module
declares ``capturable = False`` (:class:`.tensor.ChannelParallel`) and the
TP fit is stepped from the host, one read of the stop flag per iteration.

The JAX engine switches the batched path to ``backend="xla"`` (``:92-100``)
because ``vmap`` cannot map its ``pallas_call``; that is a limit of ``vmap``,
not a semantic, and the lockstep step here launches B1 over the lanes'
concatenated blocks, so the switch is not made.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..data.io import HsiSample
from ..solvers.admm import OuterStages, SolverState, init_state, make_consts, single_step
from ..solvers.batch import lockstep_step, stack_consts, stack_states
from ..solvers.dip import DipFit, DipResult, make_dip_fit
from ..utils.comm import all_gather, broadcast
from ..utils.config import SolverConfig
from ..utils.device import resolve_device
from .collectives import (
    make_distributed_svt,
    make_distributed_svt_2d,
    make_sharded_sparse_prox,
    make_sharded_sparse_prox_2d,
)
from .mesh import axis_group, axis_index, axis_size, group_root, mesh_device
from .sharding import shard, state_sharding, unshard, within_data_group
from .tensor import make_channel_constraint

_FIT_AXES = ("patch", "band")  # the axes the DIP fit is not split over


class _FitOnRoot:
    """``fit`` (a :class:`..solvers.dip.DipFit`) on the rank ``root`` of
    ``group``, its result broadcast over the group.  It takes the chunk of
    :class:`..solvers.admm.OuterStages` and passes it on to the root's fit."""

    takes_chunk = True

    def __init__(self, fit: DipFit, root: int, group):
        self.fit, self.root, self.group = fit, root, group

    def __call__(self, dip_input, target, mask, init=None, generator=None, chunk=None) -> DipResult:
        if dist.get_rank() == self.root:
            res = self.fit(dip_input, target, mask, init=init, generator=generator, chunk=chunk)
            out = res.out
            meta = torch.tensor(
                [float(res.loss), res.n_iters, float(res.stopped)], dtype=torch.float64, device=out.device
            )
        else:
            out = torch.empty_like(target, dtype=torch.float32)
            meta = torch.empty(3, dtype=torch.float64, device=out.device)
        out = broadcast(out, self.root, self.group)
        meta = broadcast(meta, self.root, self.group).tolist()
        loss = torch.tensor(meta[0], dtype=torch.float32, device=out.device)
        return DipResult(out=out, loss=loss, n_iters=int(meta[1]), stopped=bool(meta[2]))


def _fit_factory(mesh: DeviceMesh):
    """The DIP-fit hook of :class:`..solvers.admm.OuterStages`: channel TP
    over ``model`` when the mesh has it (stepped from the host: see the
    module docstring), and the fit on the rank at coordinate 0 of ``patch``
    / ``band`` with its result broadcast there."""
    fan_group = axis_group(mesh, _FIT_AXES)
    root = group_root(mesh, _FIT_AXES)
    tp = axis_size(mesh, "model") > 1

    def factory(net, dip_config):
        fit = make_dip_fit(make_channel_constraint(mesh, "model")(net) if tp else net, dip_config)
        return fit if fan_group is None else _FitOnRoot(fit, root, fan_group)

    return factory


class ShardedSolver:
    """Solver over a device mesh; takes one sample or a batch (a sequence of
    same-shaped samples).  Runs on ``device`` ('cuda' by default), which
    must be the mesh's device type."""

    def __init__(
        self,
        samples: Union[HsiSample, Sequence[HsiSample]],
        dictionary: np.ndarray,
        config: SolverConfig,
        mesh: DeviceMesh,
        net=None,
        use_collective_svt: bool = True,
        device="cuda",
        dip_init=None,
    ):
        self.device = resolve_device(device)
        if mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type!r}, the solver on {self.device.type!r}")
        self.device = mesh_device(mesh)
        self.mesh = mesh
        self.config = config
        self.batched = not isinstance(samples, HsiSample)
        samples_list = list(samples) if self.batched else [samples]
        self.samples = samples_list
        self.shape = samples_list[0].shape
        if len({s.shape for s in samples_list}) != 1:
            raise ValueError("all samples must share a shape")

        names = mesh.mesh_dim_names
        svt_fn = sparse_prox_fn = dip_fit_factory = None
        if "patch" in names:
            two_d = "band" in names
            if use_collective_svt and config.variant == "lrs_pnp":
                svt_fn = (make_distributed_svt_2d if two_d else make_distributed_svt)(mesh)
            sparse_prox_fn = (make_sharded_sparse_prox_2d if two_d else make_sharded_sparse_prox)(
                mesh, config.sparse
            )
        if config.variant in ("dip", "dip_1lip"):
            dip_fit_factory = _fit_factory(mesh)

        self.stages = OuterStages(
            config, self.shape, net=net, svt_fn=svt_fn, dip_init=dip_init, device=self.device,
            sparse_prox_fn=sparse_prox_fn, dip_fit_factory=dip_fit_factory,
        )
        if self.batched:
            n_data = axis_size(mesh, "data")
            if len(samples_list) % n_data:
                raise ValueError(f"{len(samples_list)} samples do not split over data={n_data}")
            per = len(samples_list) // n_data
            self.lanes = list(range(axis_index(mesh, "data") * per, (axis_index(mesh, "data") + 1) * per))
            self._step = lockstep_step(self.stages)
            consts = stack_consts([
                make_consts(samples_list[i], dictionary, config, device=self.device) for i in self.lanes
            ])
        else:
            self.lanes = [0]
            self._step = single_step(self.stages)
            consts = make_consts(samples_list[0], dictionary, config, device=self.device)
        self.consts = consts
        self._spec = state_sharding(mesh, self.batched).X
        self._group_spec = within_data_group(self._spec)

    def init_state(self, seed: Optional[int] = None) -> SolverState:
        """This rank's shard of the initial state (lane i seeded ``seed + i``)."""
        seed = self.config.seed if seed is None else seed
        if self.batched:
            whole = stack_states([
                init_state(self.samples[i], seed + i, device=self.device) for i in self.lanes
            ])
        else:
            whole = init_state(self.samples[0], seed, device=self.device)
        return self._keep_shard(whole)

    def _keep_shard(self, st: SolverState) -> SolverState:
        return st._replace(**{
            k: shard(getattr(st, k), self._group_spec, self.mesh) for k in ("X", "lambda1", "lambda2")
        })

    def step(self, state: SolverState):
        """One outer step on the shards: returns (new shards, aux), with the
        aux's U and phi_scatter as this rank's shards too."""
        stacked = torch.stack([state.X, state.lambda1, state.lambda2])
        whole = unshard(stacked, (None,) + self._group_spec, self.mesh)
        new, aux = self._step(state._replace(X=whole[0], lambda1=whole[1], lambda2=whole[2]), self.consts)
        aux = aux._replace(
            U=shard(aux.U, self._group_spec, self.mesh),
            phi_scatter=shard(aux.phi_scatter, self._group_spec, self.mesh),
        )
        return self._keep_shard(new), aux

    def gather(self, t: torch.Tensor, spec=None) -> torch.Tensor:
        """The whole of a sharded (P, B) tensor of the state or aux, all lanes
        of a batch included, on every rank."""
        return unshard(t, self._spec if spec is None else spec, self.mesh)

    def _lanes_metric(self, v) -> np.ndarray:
        """A per-lane metric of every lane, gathered over ``data``."""
        v = torch.as_tensor(v, dtype=torch.float32, device=self.device)
        if self.batched:
            v = all_gather(v.reshape(-1), axis_group(self.mesh, ("data",)), 0)
        return v.cpu().numpy()

    def run(self, n_iters: Optional[int] = None, state=None, callback=None):
        """Returns (final shards, hist) with ``mpsnr`` and ``ssim`` of shape
        (n_iters,) or, for a batch, (n_iters, n_lanes)."""
        n = self.config.outer_iters if n_iters is None else n_iters
        state = self.init_state() if state is None else state
        hist = {"mpsnr": [], "ssim": []}
        for i in range(n):
            state, aux = self.step(state)
            hist["mpsnr"].append(self._lanes_metric(aux.mpsnr))
            hist["ssim"].append(self._lanes_metric(aux.ssim))
            if callback is not None:
                callback(i, state, aux)
        return state, {k: np.stack(v) for k, v in hist.items()}

