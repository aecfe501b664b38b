"""Traffic ``cube_steps``: solves of ``steps_per_solve`` outer steps through
``Solver.run``, each from ``Solver.init_state()``, on cubes taken
round-robin from a pool of ``pool``; one ``Solver`` per cube, built and
warmed at set-up, so each fit replays its captured graph as it does across
one long solve.  The DIP net's initial weights of outer step ``k`` of cube
``c`` are a draw of their own, made on the card when the program asks for
them through ``Solver``'s ``dip_init`` hook, and made again alike for the
reference.

The pool and its weights come from the cell's ``problem_seed``, the same in
every run, and ``--seed`` only sets where the round-robin starts and which
solve and steps the check follows.  The early stop sets a fit's length by
the data (146 to 290 iterations a step over the cubes tried), so cubes drawn
from ``--seed`` would change the work from run to run; and a fit is chaotic
at the scale of rounding, so a change that only reorders the program's
arithmetic changes each fit's length: the pool spreads that over
``pool`` x ``steps_per_solve`` fits a window.

The check follows the program step by step, as only the program's own state
lets it: the reference runs outer step ``k`` from the state the program's
step ``k - 1`` produced (step 0 from the reference's own initial state,
X = Y) and is held against the program twice:

* ``state_gap``: with the program's DIP output as the low-rank prox, the
  reference's new state (X, lambda1, lambda2) against the program's (the
  sparse prox, B1, the fidelity update and the duals);
* ``fit_loss_excess`` and ``fit_u_gap``: the reference's own fit in float32
  from the same state and initial weights, against the program's output:
  how far the program's masked loss lies above the reference's, as a share
  of it, and the L2 gap of the outputs over the observed cube's norm.  Two
  sound fits part within a few iterations (Adam at lr 0.1 moves a weight
  whose gradient is below its eps by an amount that follows the gradient's
  rounding), so these limits catch a fit that does not fit (a net left at
  its initial weights, a fit cut short, a wrong update), not one in a lower
  precision."""

from __future__ import annotations

import numpy as np
import torch

import program
from reference import skip128
from reference import solver as ref
from yardstick import flops as fl
from yardstick import inputs

from .base import Context, Record, blocks_per_cube, gap, now, reference_precision, synchronize

KEPT_SOLVES = 3  # the solves whose every step the check may pick


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.n_steps = ctx.cell["steps_per_solve"]
        self.kept = []  # per kept solve: (cube, [(X, lambda1, lambda2, U) of each step])
        self.kept_iters = []  # per kept solve: the DIP iterations of each step
        self.rows = []  # the last check's numbers of each step, for control.py
        self.start = int(np.random.default_rng(inputs.sub_seeds(ctx.seed, 1, inputs.ORDER)[0])
                         .integers(ctx.cell["pool"]))

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        ctx, p = self.ctx, self.ctx.problem
        seed, n = ctx.cell["problem_seed"], ctx.cell["pool"]
        self.pool = [(noisy, mask) for noisy, mask, _ in inputs.problem_pool(
            seed, n, p["height"], p["width"], p["bands"], p["rank"], p["missing"], p["noise_sigma"])]
        self.init_seeds = inputs.sub_seeds(seed, n * self.n_steps, inputs.DIP_INITS)
        self.spec = skip128.param_spec(p["bands"])
        self.solvers = []
        for c, (noisy, mask) in enumerate(self.pool):
            solver = program.Solver(
                program.HsiSample(noisy=noisy, mask=mask), ctx.dictionary, ctx.cfg,
                device=ctx.device, dip_init=lambda itr, c=c: self.init(c, itr))
            # warm-up: one outer step builds B1, sets cuDNN up and captures this solver's fit
            solver.run(n_iters=1, state=solver.init_state())
            self.solvers.append(solver)
        synchronize(ctx.device)

    def init(self, c: int, k: int) -> dict:
        """The DIP net's initial weights of outer step ``k`` of cube ``c``."""
        gen = torch.Generator(device=self.ctx.device)
        gen.manual_seed(self.init_seeds[c * self.n_steps + k])
        return skip128.init_params(self.spec, gen, self.ctx.device)

    def cube(self, i: int) -> int:
        return (self.start + i) % len(self.pool)

    # -- the window ----------------------------------------------------------

    def request(self, i: int) -> Record:
        c, keep = self.cube(i), i < KEPT_SOLVES
        solver, states = self.solvers[c], []

        def record(_, state, aux):
            states.append((state.X.clone(), state.lambda1.clone(), state.lambda2.clone(), aux.U.clone()))

        t0 = now()
        _, hist = solver.run(n_iters=self.n_steps, state=solver.init_state(), callback=record if keep else None)
        synchronize(self.ctx.device)
        t1 = now()
        if keep:
            self.kept.append((c, states))
            self.kept_iters.append([int(n) for n in hist["dip_iters"]])
        info = {"seconds": list(hist["seconds"]), "dip_iters": [int(n) for n in hist["dip_iters"]]}
        return Record(t0, t1, tiles=0, steps=self.n_steps, info=info)

    def traced(self) -> None:
        """The stretch the profiler sees: ``trace_steps`` outer steps."""
        solver = self.solvers[self.cube(0)]
        solver.run(n_iters=self.ctx.cell["trace_steps"], state=solver.init_state())
        synchronize(self.ctx.device)

    def release(self) -> None:
        self.solvers = None

    # -- counts --------------------------------------------------------------

    def _b1_launch(self) -> tuple:
        p, s = self.ctx.problem, self.ctx.setup
        return blocks_per_cube(self.ctx, p["height"], p["width"]), s.block_size ** 2, p["atoms"], s.n_iter

    def flops(self, rec: Record) -> int:
        p = self.ctx.problem
        sparse = fl.sparse_step(*self._b1_launch())
        return sum(sparse + fl.dip_fit(p["height"], p["width"], p["bands"], n) for n in rec.info["dip_iters"])

    def traced_b1_work(self) -> list:
        """[(nB, P, K, n_iter)]: B1's work in the traced stretch, one entry
        per outer step."""
        return [self._b1_launch()] * self.ctx.cell["trace_steps"]

    # -- the check -----------------------------------------------------------

    def _picks(self) -> tuple:
        """The solve and the steps the check follows, drawn from the seed:
        step 0 (the start) and ``checked_steps - 1`` others."""
        rng = np.random.default_rng(inputs.sub_seeds(self.ctx.seed, 1, inputs.CHECK_PICKS)[0])
        solve = int(rng.integers(len(self.kept)))
        others = rng.choice(np.arange(1, self.n_steps), self.ctx.cell["checked_steps"] - 1, replace=False)
        return solve, [0] + sorted(int(k) for k in others)

    def readings(self, control: bool = False) -> dict:
        """Over the checked steps of the program (or, with ``control``, of
        the reference in TF32 put in its place: its sparse prox and update
        with the program's DIP output, and its own fit) against the reference
        in float32 from the same state: the widest ``state_gap``, and the
        median ``fit_loss_excess`` and ``fit_u_gap``.  Now and then one
        sound fit of the two stops learning early (its sigmoid saturated,
        or the early stop caught it on a plateau) and the other does not,
        so a single step can read like a fault: the median of the steps
        leaves one or two such steps out, while a fault that breaks the fit
        reads on every step."""
        ctx = self.ctx
        solve, steps = self._picks()
        c, chain = self.kept[solve]
        pr = ref.problem(*self.pool[c], ctx.dictionary, ctx.setup, ctx.device)
        y_norm = float(torch.linalg.norm(pr.Y))
        state_gap, excess, rels, self.rows = 0.0, [], [], []
        for k in steps:
            start = ref.initial_state(pr) if k == 0 else ref.State(*chain[k - 1][:3])
            U = chain[k][3]
            with reference_precision(ctx.device, tf32=False):
                state = ref.finish(start, pr, ref.sparse_stage(start, pr, ctx.setup), U, ctx.setup)
                fit, n = ref.dip_prox(start, pr, ctx.setup, self.init(c, k))
            if control:
                with reference_precision(ctx.device, tf32=True):
                    got = ref.finish(start, pr, ref.sparse_stage(start, pr, ctx.setup), U, ctx.setup)
                    got_fit = ref.dip_prox(start, pr, ctx.setup, self.init(c, k)).out
            else:
                got, got_fit = ref.State(*chain[k][:3]), U
            rel = float(torch.linalg.norm(got_fit - fit)) / y_norm
            more = ref.masked_loss(got_fit, pr) / ref.masked_loss(fit, pr) - 1.0
            step_gap = max(gap(a, b) for a, b in zip(got, state))
            state_gap = max(state_gap, step_gap)
            excess.append(more if np.isfinite(more) else np.inf)
            rels.append(rel if np.isfinite(rel) else np.inf)
            self.rows.append({"step": k, "iters": self.kept_iters[solve][k], "ref_iters": n,
                              "loss_excess": excess[-1], "u_gap": rels[-1], "state_gap": step_gap,
                              "norm_u": float(torch.linalg.norm(got_fit)), "norm_ref": float(torch.linalg.norm(fit))})
        return {"state_gap": state_gap, "fit_loss_excess": float(np.median(excess)),
                "fit_u_gap": float(np.median(rels))}
