"""Traffic ``cube_steps_fast``: the traffic of ``cube_steps`` (its window,
requests, traced stretch, picks and operation count, skip-128's) under the
``dip_fast`` configuration, checked against the bfloat16 reference
(:mod:`reference.bf16`) in place of the float32 one.

The check reads ``cube_steps``'s three numbers, the 1-Lip driver's
``net_gap``, and a fifth, ``window_gap``, each against the bf16 reference,
from the program's own state as ``cube_steps`` follows it.  Each limit lies
between the program's largest reading over a dozen problems and more and the
smallest reading of the control (the reference with fp8 operands in the
program's place, ``readings(control=True)``) or of a fault that the number
catches, over three or more (PERF.md, §6):

* ``state_gap``: the widest max|d|/max|ref| over X, lambda1 and lambda2 of
  the checked steps, the reference's sparse prox (B1 with bf16 operands)
  and update given the program's DIP output.  Limit 3e-4: B1 sums its bf16
  products on the tensor cores in another order than the reference, which
  flips an operand's rounding now and then (program at most 4.1e-6); fp8
  operands read 3.1e-3 and more, a pixel altered 0.058;
* ``fit_loss_excess`` and ``fit_u_gap``: the program's DIP output against the
  reference's own bf16 fit from the same state and initial weights, the
  median over the checked steps.  Two sound fits part within a few
  iterations, so these catch a fit that does not fit, not a precision:
  limits 0.3 and 0.2 (program at most 0.021 and 0.099; a fit cut after one
  chunk 0.88 and 0.34, the fp8 fit 0.93 and 0.40);
* ``net_gap``: the net's first forward in bf16, as the timed path computes
  it (a one-iteration fit's output, from the replay of its captured
  iteration; the mean of a window of one is that output), against the
  reference's bf16 forward from the same weights, max|d|/max|ref|.  Limit
  0.05: two bf16 forwards that sum in other orders part by some bf16
  roundings of the output (program at most 0.0046); fp8 operands 0.19;
* ``window_gap``: a two-iteration fit's output, the mean of its two outputs
  under ``window_mean``, as the timed path returns it, against the
  reference's, ||d|| / ||Y||.  Limit 0.3: Adam's first step moves every
  weight by about the learning rate, so the second outputs of two sound
  fits part a little (program at most 0.105), while the last output in
  place of the mean lies half the first step away (0.65 and more) and fp8
  operands 0.64 and more.  The full fits part too far to see the return:
  with the last output they read like sound fits."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import program
from reference import bf16
from reference import solver as ref

from . import cube_steps
from .base import gap, reference_precision


class Driver(cube_steps.Driver):
    def setup(self) -> None:
        bf16.require_bf16(self.ctx.setup)
        super().setup()

    # -- the check -----------------------------------------------------------

    def _program_fit(self, c: int, n_iters: int) -> torch.Tensor:
        """The program's DIP output (P, B) of outer step 0 of cube ``c`` with
        an ``n_iters``-iteration fit, from the second of two runs (the
        replay)."""
        ctx = self.ctx
        cfg = dataclasses.replace(ctx.cfg, dip=dataclasses.replace(ctx.cfg.dip, num_iter=n_iters))
        noisy, mask = self.pool[c]
        solver = program.Solver(program.HsiSample(noisy=noisy, mask=mask), ctx.dictionary, cfg,
                                device=ctx.device, dip_init=lambda itr: self.init(c, 0))
        outs = []
        for _ in range(2):
            solver.run(n_iters=1, state=solver.init_state(), callback=lambda i, st, aux: outs.append(aux.U))
        return outs[-1]

    def readings(self, control: bool = False) -> dict:
        """The widest ``state_gap``, the median ``fit_loss_excess`` and
        ``fit_u_gap`` over the checked steps, ``net_gap`` and
        ``window_gap``, of the program (or, with ``control``, of the
        reference with fp8 operands) against the bf16 reference."""
        ctx, s = self.ctx, self.ctx.setup
        solve, steps = self._picks()
        c, chain = self.kept[solve]
        pr = ref.problem(*self.pool[c], ctx.dictionary, s, ctx.device)
        y_norm = float(torch.linalg.norm(pr.Y))
        state_gap, excess, rels, self.rows = 0.0, [], [], []
        with reference_precision(ctx.device, tf32=False):
            for k in steps:
                start = ref.initial_state(pr) if k == 0 else ref.State(*chain[k - 1][:3])
                U = chain[k][3]
                state = bf16.step(start, pr, s, U=U).state
                fit, n = bf16.dip_prox(start, pr, s, self.init(c, k))
                if control:
                    got = bf16.step(start, pr, s, U=U, control=True).state
                    got_fit = bf16.dip_prox(start, pr, s, self.init(c, k), control=True).out
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
                                  "norm_u": float(torch.linalg.norm(got_fit)),
                                  "norm_ref": float(torch.linalg.norm(fit))})
            start = ref.initial_state(pr)
            first, two = (bf16.dip_prox(start, pr, s, self.init(c, 0), dip_iters=n).out for n in (1, 2))
            if control:
                got_first, got_two = (bf16.dip_prox(start, pr, s, self.init(c, 0), dip_iters=n, control=True).out
                                      for n in (1, 2))
        if not control:
            got_first, got_two = self._program_fit(c, 1), self._program_fit(c, 2)
        window_gap = float(torch.linalg.norm(got_two - two)) / y_norm
        return {"state_gap": state_gap, "fit_loss_excess": float(np.median(excess)),
                "fit_u_gap": float(np.median(rels)), "net_gap": gap(got_first, first),
                "window_gap": window_gap if np.isfinite(window_gap) else np.inf}
