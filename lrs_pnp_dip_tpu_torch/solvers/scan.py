"""The device-resident outer loop: the counterpart of the JAX package's
``Solver.run_scanned``, ``SeedEnsembleSolver.run_scanned`` / ``run_chunked``
and the tiled engine's ``scan=True``, which run N outer steps as one
``lax.scan``.

:class:`ScannedSolve` keeps the state (``X``, ``lambda1``, ``lambda2``) and
reads the problem's constants in place (the caller's tensors, whose storage
stays put: the tiled engine refills them for its next batch), and runs each
outer step as

  1. graph A: the blocks, the sparse prox (kernel B1 inside the graph on
     the card), and for ``lrs_pnp`` the Gram matrix of X + lambda2/mu2;
  2. on the host: ``torch.linalg.eigh`` of the Gram matrix (``lrs_pnp``;
     cuSOLVER's status is checked on the host, which a graph cannot
     capture: one host sync per step), or the DIP fit of each lane through
     the one captured fit of :class:`.dip.DipFit` (one read of its stop flag
     per ``FIT_CHUNK`` iterations, the fit that :meth:`.admm.Solver.run`
     and the lockstep engines' ``run`` replay too), or a custom ``svt_fn``;
  3. graph B: the rest of the SVT, the data-fidelity update, the duals, the
     metrics (and the ensemble's, for a seed ensemble); it writes the step's
     scalars into a history buffer on the device at a device-side index and
     the new state over the old.

The host reads the history once per chunk of outer steps (once at the end
by default).  On the card the first step runs A and B eagerly (their
warm-up) and the second captures them (:class:`.graphs.Captured`).  On the
CPU the same bodies run eagerly, step for step the operations of the
host-stepped loop, so the results equal :meth:`.admm.Solver.run`'s and
:meth:`.batch.SeedEnsembleSolver.run`'s bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.metrics import mpsnr
from ..ops.ssim import ssim
from ..ops.svt import gram, svt_from_eigh, svt_gram
from ..utils.profiling import annotate
from .admm import OuterStages, ProblemConsts, SolverState
from .batch import _lane_consts, _lane_state, lockstep_finish, lockstep_sparse
from .dip import DipFit
from .graphs import Captured


class ScannedSolve:
    """The outer step of ``stages`` on tensors of its own, for one problem
    (``lanes=False``: ``consts`` of one problem) or stacked lanes
    (``lanes=True``; ``ensemble=True`` adds the metrics of the lanes' mean
    cube).  :meth:`run` steps it.  ``consts`` are read in place, so the
    caller keeps their storage and may refill them with another problem of
    the same shapes between runs (the tiled engine's next batch)."""

    def __init__(
        self, stages: OuterStages, consts: ProblemConsts, lanes: bool = False, ensemble: bool = False
    ):
        if stages.dip_fit is not None and not isinstance(stages.dip_fit, DipFit):
            raise ValueError("the device-resident solve runs the port's own DIP fit (no dip_fit_factory)")
        self.stages = stages
        self.device = stages.device
        self.lanes = lanes
        self.ensemble = ensemble
        self.consts = consts
        shape = self.consts.Y.shape  # (P, B) or (N, P, B)
        self.n_lanes = shape[0] if lanes else 1

        def zeros(*dims):
            return torch.zeros(dims, dtype=torch.float32, device=self.device)

        self.X, self.lambda1, self.lambda2 = (zeros(*shape) for _ in range(3))
        self.dip = stages.dip_fit is not None
        self.split_svt = not self.dip and stages.svt_fn is svt_gram
        if self.split_svt:
            b = shape[-1]
            self.w, self.V = zeros(*shape[:-2], b), zeros(*shape[:-2], b, b)
        else:
            self.U = zeros(*shape)
        self.dip_iters, self.dip_loss = zeros(self.n_lanes), zeros(self.n_lanes)
        self.n_cols = 3 * self.n_lanes + 2 * ensemble if lanes else 6
        self.hist = zeros(0, self.n_cols)
        self.idx = torch.zeros((), dtype=torch.int64, device=self.device)
        self._pre = Captured(self._pre_fn, self.device)
        self._post = Captured(self._post_fn, self.device)
        self._pre_out = None

    # -- the three parts of a step -------------------------------------------

    def _state(self, generator=None, itr: int = 0) -> SolverState:
        if self.lanes and generator is None:
            generator = (None,) * self.n_lanes
        return SolverState(self.X, self.lambda1, self.lambda2, generator, itr)

    def _pre_fn(self):
        st, stages = self._state(), self.stages
        phi = lockstep_sparse(stages, st, self.consts) if self.lanes else stages.sparse(st, self.consts)
        return phi, gram(stages.low_rank_input(st)) if self.split_svt else None

    def _mid(self, generator, itr: int) -> None:
        stages, st = self.stages, self._state(generator, itr)
        if self.split_svt:
            with annotate("svt.eigh"):
                w, V = torch.linalg.eigh(self._pre_out[1])
                self.w.copy_(w)
                self.V.copy_(V)
        elif not self.dip:
            self.U.copy_(stages.svt(stages.low_rank_input(st)))
        elif not self.lanes:
            U, n_iters, loss = stages.low_rank(st, self.consts)
            self.U.copy_(U)
            self.dip_iters.fill_(n_iters)
            self.dip_loss.copy_(loss)
        else:
            for i in range(self.n_lanes):
                U, n_iters, loss = stages.low_rank(_lane_state(st, i), _lane_consts(self.consts, i))
                self.U[i].copy_(U)
                self.dip_iters[i].fill_(n_iters)
                self.dip_loss[i].copy_(loss)

    def _post_fn(self) -> None:
        stages, st, consts = self.stages, self._state(), self.consts
        phi = self._pre_out[0]
        if self.split_svt:
            U = svt_from_eigh(stages.low_rank_input(st), self.w, self.V, 1.0 / stages.config.mu2)
        else:
            U = self.U
        if self.lanes:
            low_rank = [(U[i], self.dip_iters[i], self.dip_loss[i]) for i in range(self.n_lanes)]
            new, aux = lockstep_finish(stages, st, consts, phi, low_rank)
            row = [aux.mpsnr, aux.ssim, self.dip_iters]
            if self.ensemble:
                mean_cube = torch.mean(new.X, dim=0).reshape(stages.image_shape)
                row.append(torch.stack([mpsnr(consts.clean[0], mean_cube), ssim(consts.clean[0], mean_cube)]))
            row = torch.cat(row)
        else:
            new, aux = stages.finish(st, consts, phi, U, self.dip_iters[0], self.dip_loss[0])
            row = torch.stack([aux.mpsnr, aux.ssim, aux.x_dist, aux.l1_dist, aux.l2_dist, self.dip_iters[0]])
        self.hist.index_copy_(0, self.idx.reshape(1), row[None])
        self.idx.add_(1)
        self.X.copy_(new.X)
        self.lambda1.copy_(new.lambda1)
        self.lambda2.copy_(new.lambda2)

    # -- the loop ------------------------------------------------------------

    def _load(self, state: SolverState) -> None:
        self.X.copy_(state.X)
        self.lambda1.copy_(state.lambda1)
        self.lambda2.copy_(state.lambda2)
        self.idx.zero_()

    def run(self, state: SolverState, n: int, chunk: Optional[int] = None):
        """Run ``n`` outer steps from ``state``; returns (final state, the
        history as an (n, columns) array).  The history is read from the
        device once per ``chunk`` steps (default: once, at the end)."""
        if n > self.hist.shape[0]:
            self.hist = torch.zeros((n, self.n_cols), dtype=torch.float32, device=self.device)
            self._post.reset()  # graph B writes into the history
        self._load(state)
        rows, done = [], 0
        while done < n:
            length = n if chunk is None else min(chunk, n - done)
            for k in range(done, done + length):
                with annotate("step.graph_a"):
                    self._pre_out = self._pre()
                self._mid(state.generator, state.itr + k)
                with annotate("step.graph_b"):
                    self._post()
            with annotate("step.history_read"):
                rows.append(self.hist[done : done + length].cpu().numpy())
            done += length
        final = SolverState(
            self.X.clone(), self.lambda1.clone(), self.lambda2.clone(), state.generator, state.itr + n
        )
        return final, np.concatenate(rows) if rows else np.zeros((0, self.n_cols), np.float32)
