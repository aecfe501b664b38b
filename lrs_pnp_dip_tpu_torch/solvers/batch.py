"""Lockstep engines: several same-shaped problems, or one problem under
several seeds, advancing one outer step at a time (counterpart of
``lrs_pnp_dip_tpu/solvers/batch.py``, which ``vmap``s the step).

How the lanes are batched here:

  * the sparse prox of all lanes is ONE call of :func:`..ops.ista.sparse_prox`
    (one launch of kernel B1 on the card): the lanes' blocks, masks and step
    sizes are concatenated to ``(N * nB, P)`` against the one dictionary,
    which is kept once, not N times;
  * the SVT of all `lrs_pnp` lanes is one batched ``eigh``;
  * the DIP fits run lane by lane, each from its own generator with its own
    Adam and its own early stop: what ``while_loop`` under ``vmap`` computes,
    without the finished lanes idling.  Every lane's fit replays the one
    captured iteration of the engine's :class:`.dip.DipFit` (one capture per
    net and shape, not per lane);
  * the data-fidelity update, the duals and the metrics are looped over the
    lanes through the single-problem stage.

A stacked :class:`SolverState` holds ``X``, ``lambda1``, ``lambda2`` as
``(N, P, B)`` and a tuple of N generators; a stacked :class:`ProblemConsts`
holds every field with a leading lane axis except ``D``.
:meth:`SeedEnsembleSolver.run` steps the outer loop from the host;
:meth:`SeedEnsembleSolver.run_scanned` and
:meth:`SeedEnsembleSolver.run_chunked` run the same step on the device
(:mod:`.scan`: CUDA graphs on the card, the lanes' DIP fits one after
another through the one captured fit), the ensemble metrics inside the
step.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..data.io import HsiSample
from ..ops.metrics import mpsnr
from ..ops.ssim import ssim
from ..utils.config import SolverConfig
from ..utils.device import resolve_device
from .admm import OuterStages, ProblemConsts, SolverState, StepAux, init_state, make_consts


def stack_consts(consts: Sequence[ProblemConsts]) -> ProblemConsts:
    """Stack per-lane constants; the dictionary (the first lane's) is kept once."""
    fields = {
        name: torch.stack([getattr(c, name) for c in consts])
        for name in ProblemConsts._fields if name != "D"
    }
    return ProblemConsts(D=consts[0].D, **fields)


def stack_states(states: Sequence[SolverState]) -> SolverState:
    return SolverState(
        X=torch.stack([s.X for s in states]),
        lambda1=torch.stack([s.lambda1 for s in states]),
        lambda2=torch.stack([s.lambda2 for s in states]),
        generator=tuple(s.generator for s in states),
        itr=states[0].itr,
    )


def _lane_state(state: SolverState, i: int) -> SolverState:
    return SolverState(
        state.X[i], state.lambda1[i], state.lambda2[i], state.generator[i], state.itr
    )


def _lane_consts(consts: ProblemConsts, i: int) -> ProblemConsts:
    return ProblemConsts(
        D=consts.D, **{n: getattr(consts, n)[i] for n in ProblemConsts._fields if n != "D"}
    )


def build_lockstep_step(
    config: SolverConfig,
    image_shape: tuple,  # (H, W, B)
    net=None,
    svt_fn: Optional[Callable] = None,
    dip_init: Optional[Callable[[int], Mapping[str, torch.Tensor]]] = None,
    device="cuda",
    sparse_prox_fn: Optional[Callable] = None,
    dip_fit_factory: Optional[Callable] = None,
) -> Callable[[SolverState, ProblemConsts], tuple]:
    """Build ``step(state, consts) -> (state, aux)`` over stacked lanes (any
    number of them: the step reads it off the state).  ``aux`` holds each
    tensor field of :class:`StepAux` stacked and ``dip_iters`` as a list.
    The arguments are :class:`OuterStages`'s."""
    return lockstep_step(OuterStages(
        config, image_shape, net, svt_fn, dip_init, device, sparse_prox_fn, dip_fit_factory
    ))


def lockstep_sparse(stages: OuterStages, state: SolverState, consts: ProblemConsts) -> torch.Tensor:
    """Stage 1 of stacked lanes: one sparse prox over the blocks of every
    lane; returns Phi_z (N, nB, bb*bb)."""
    n_lanes = state.X.shape[0]
    blocks = torch.cat([stages.sparse_blocks(_lane_state(state, i)) for i in range(n_lanes)])
    return stages.sparse_prox_fn(
        blocks, consts.mask_blocks.flatten(0, 1), consts.D, alpha=consts.alpha.flatten()
    ).reshape(n_lanes, -1, blocks.shape[1])


def lockstep_finish(stages: OuterStages, state: SolverState, consts: ProblemConsts, phi, low_rank):
    """Stages 3 to 5 lane by lane from Phi_z and each lane's (U, dip_iters,
    dip_loss): (stacked state, aux)."""
    done = [
        stages.finish(_lane_state(state, i), _lane_consts(consts, i), phi[i], *low_rank[i])
        for i in range(state.X.shape[0])
    ]
    aux = StepAux(*(
        [a[k] for _, a in done] if name == "dip_iters"
        else torch.stack([a[k] for _, a in done])
        for k, name in enumerate(StepAux._fields)
    ))
    return stack_states([s for s, _ in done]), aux


def lockstep_step(stages: OuterStages) -> Callable[[SolverState, ProblemConsts], tuple]:
    """The lockstep step of stacked lanes through ``stages``."""

    def step(state: SolverState, consts: ProblemConsts):
        n_lanes = state.X.shape[0]
        phi = lockstep_sparse(stages, state, consts)
        # 2. low-rank prox: one batched SVT, or the DIP fits lane by lane
        if stages.dip_fit is None:
            U, no_iters, no_loss = stages.low_rank(state, consts)
            low_rank = [(U[i], no_iters, no_loss) for i in range(n_lanes)]
        else:
            low_rank = [
                stages.low_rank(_lane_state(state, i), _lane_consts(consts, i))
                for i in range(n_lanes)
            ]
        return lockstep_finish(stages, state, consts, phi, low_rank)

    return step


def _run(step, state, n: int, callback=None):
    """Step ``n`` times; per-lane histories as (n, n_lanes) arrays."""
    hist = {k: [] for k in ("mpsnr", "ssim", "dip_iters")}
    for i in range(n):
        state, aux = step(state)
        hist["mpsnr"].append(aux.mpsnr.detach().cpu().numpy())
        hist["ssim"].append(aux.ssim.detach().cpu().numpy())
        hist["dip_iters"].append(np.asarray(aux.dip_iters, np.int32))
        if callback is not None:
            callback(i, state, aux)
    return state, {k: np.stack(v) for k, v in hist.items()}


class _LockstepEngine:
    """What the two engines share: the device, the lockstep step over
    ``self.consts`` and the host-stepped run.  A subclass sets ``consts`` and
    defines ``init_state()``."""

    def __init__(self, config: SolverConfig, shape: tuple, net, device, dip_init):
        self.device = resolve_device(device)
        self.config = config
        self.shape = shape
        self.stages = OuterStages(config, shape, net=net, dip_init=dip_init, device=self.device)
        self._step = lockstep_step(self.stages)

    def step(self, state: SolverState):
        return self._step(state, self.consts)

    def run(self, n_iters: Optional[int] = None, state=None, callback=None):
        """Returns (final_state, hist) with ``mpsnr``, ``ssim`` and
        ``dip_iters`` of shape (n_iters, n_lanes)."""
        n = self.config.outer_iters if n_iters is None else n_iters
        state = self.init_state() if state is None else state
        return _run(self.step, state, n, callback=callback)


class BatchedSolver(_LockstepEngine):
    """Solve N same-shaped problems in lockstep.  Lane i is seeded with
    ``seed + i``.  Runs on ``device`` ('cuda' by default; raises without a
    card unless ``device='cpu'``)."""

    def __init__(
        self,
        samples: Sequence[HsiSample],
        dictionary: np.ndarray,
        config: SolverConfig,
        net=None,
        device="cuda",
        dip_init: Optional[Callable[[int], Mapping[str, torch.Tensor]]] = None,
    ):
        shapes = {s.shape for s in samples}
        if len(shapes) != 1:
            raise ValueError(f"all samples must share a shape, got {shapes}")
        super().__init__(config, samples[0].shape, net, device, dip_init)
        self.samples = list(samples)
        self.consts = stack_consts(
            [make_consts(s, dictionary, config, device=self.device) for s in samples]
        )

    def init_state(self, seed: Optional[int] = None) -> SolverState:
        seed = self.config.seed if seed is None else seed
        return stack_states(
            [init_state(s, seed + i, device=self.device) for i, s in enumerate(self.samples)]
        )

    def result_cubes(self, state: SolverState) -> np.ndarray:
        h, w, b = self.shape
        return state.X.detach().cpu().numpy().reshape(-1, h, w, b)


class SeedEnsembleSolver(_LockstepEngine):
    """Solve ONE problem under N independent seeds in lockstep.

    The DIP variants are stochastic (a fresh net every outer iteration,
    reference ``main_LRS_PnP_DIP_pro.py:215-221``), so production recovery
    wants the seed spread, or the cube averaged over the seeds, not a single
    draw.  The problem constants are built once and shared by the lanes."""

    def __init__(
        self,
        sample: HsiSample,
        dictionary: np.ndarray,
        config: SolverConfig,
        seeds: Sequence[int],
        net=None,
        device="cuda",
        dip_init: Optional[Callable[[int], Mapping[str, torch.Tensor]]] = None,
    ):
        if not seeds:
            raise ValueError("need at least one seed")
        super().__init__(config, sample.shape, net, device, dip_init)
        self.sample = sample
        self.seeds = list(seeds)
        one = make_consts(sample, dictionary, config, device=self.device)
        # every lane views the one copy (a lane axis of stride 0)
        self.consts = ProblemConsts(D=one.D, **{
            name: getattr(one, name).expand(len(self.seeds), *getattr(one, name).shape)
            for name in ProblemConsts._fields if name != "D"
        })
        self._scan = None

    def init_state(self) -> SolverState:
        return stack_states(
            [init_state(self.sample, s, device=self.device) for s in self.seeds]
        )

    def run(self, n_iters: Optional[int] = None, state=None):
        """Returns (final_state, hist): per-seed ``mpsnr``, ``ssim`` and
        ``dip_iters`` of shape (n_iters, n_seeds), and ``ens_mpsnr`` /
        ``ens_ssim`` (n_iters,), the quality of the mean of the N seed
        iterates at every iteration."""
        clean = self.consts.clean[0]
        ens = {"ens_mpsnr": [], "ens_ssim": []}

        def ens_metrics(i: int, st: SolverState, aux: StepAux) -> None:
            mean_cube = torch.mean(st.X, dim=0).reshape(self.shape)
            ens["ens_mpsnr"].append(float(mpsnr(clean, mean_cube)))
            ens["ens_ssim"].append(float(ssim(clean, mean_cube)))

        state, hist = super().run(n_iters, state, callback=ens_metrics)
        hist.update({k: np.asarray(v, np.float32) for k, v in ens.items()})
        return state, hist

    def run_scanned(self, n_iters: Optional[int] = None, state=None):
        """All iterations of all seeds on the device (:mod:`.scan`), the
        ensemble metrics computed inside the step; the history, read once at
        the end, is :meth:`run`'s (equal bits on the CPU)."""
        return self.run_chunked(n_iters, state, chunk=None)

    def run_chunked(self, n_iters: Optional[int] = None, state=None, chunk: Optional[int] = 25):
        """:meth:`run_scanned` read back ``chunk`` outer steps at a time: one
        host read of the history per chunk, a final partial chunk at its
        remainder length (``chunk=None``: one read at the end)."""
        if chunk is not None and chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        from .scan import ScannedSolve

        n = self.config.outer_iters if n_iters is None else n_iters
        state = self.init_state() if state is None else state
        if self._scan is None:
            self._scan = ScannedSolve(self.stages, self.consts, lanes=True, ensemble=True)
        state, rows = self._scan.run(state, n, chunk)
        k = len(self.seeds)
        hist = {
            "mpsnr": rows[:, :k], "ssim": rows[:, k : 2 * k],
            "dip_iters": rows[:, 2 * k : 3 * k].astype(np.int32),
            "ens_mpsnr": rows[:, 3 * k], "ens_ssim": rows[:, 3 * k + 1],
        }
        return state, hist

    def spread(self, hist) -> dict:
        """Per-seed best MPSNR + aggregate stats from a run's history."""
        best = np.nanmax(np.asarray(hist["mpsnr"]), axis=0)  # (n_seeds,)
        return {
            "per_seed_best": best.tolist(),
            "mean": float(np.mean(best)),
            "std": float(np.std(best)),
            "min": float(np.min(best)),
            "max": float(np.max(best)),
        }
