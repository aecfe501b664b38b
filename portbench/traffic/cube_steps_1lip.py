"""Traffic ``cube_steps_1lip``: the traffic of ``cube_steps`` (its window,
requests, traced stretch and picks) with the ``dip_1lip`` preset's net, the
Lipschitz U-Net, in place of skip-128: its own initial weights (the
power-iteration vectors u among them), its own operation count and the
reference's 1-Lip fit in the check.

Each record's ``info`` carries the net's ``power_products`` (the
matrix-vector products its spectral norms run per forward), or None where
the program does not count them.

The check reads ``cube_steps``'s three numbers with the 1-Lip fit, and a
fourth, ``net_gap``: the net's first forward at the published widths, as
the timed path computes it, against the reference's.  After the window a
``Solver`` of the cell's configuration with a one-iteration fit runs outer
step 0 of a checked cube from that step's initial weights, twice through
``Solver.run``: the first runs the fit's iteration eagerly (the warm-up of
its graph), the second replays the captured iteration, as every fit of the
window does.  The second's DIP output is the output of that first forward,
the spectral norms' estimates included (the replays after the first
iteration leave it as it was), and ``net_gap`` holds it to the reference's
one-iteration fit in float32 by :func:`.base.gap`."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import program
from reference import lipschitz_unet as lip
from reference import solver as ref
from yardstick import flops as fl

from . import cube_steps
from .base import Record, gap, reference_precision


class Driver(cube_steps.Driver):
    def _net(self) -> dict:
        """The net's sizes: its width from the configuration's ``solver``
        (with a test's overrides), its power steps from the file's ``net``."""
        return {"width_ch": self.ctx.cfg.net_width, "power_iters": self.ctx.config["net"]["power_iters"]}

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        cfg = self.ctx.cfg
        if cfg.sn_mode != "power" or cfg.ln_lambda <= 0:
            raise ValueError("the 1-Lip reference estimates sigma by power iteration, with the constraint on")
        self.lip_spec = lip.param_spec(self.ctx.problem["bands"], cfg.net_width)
        super().setup()
        net = self.solvers[0].stages.dip_fit.model
        self.power_products = getattr(net, "power_products", None)

    def init(self, c: int, k: int) -> dict:
        """The 1-Lip net's initial weights of outer step ``k`` of cube ``c``."""
        gen = torch.Generator(device=self.ctx.device)
        gen.manual_seed(self.init_seeds[c * self.n_steps + k])
        return lip.init_params(self.lip_spec, gen, self.ctx.device)

    # -- the window ----------------------------------------------------------

    def request(self, i: int) -> Record:
        rec = super().request(i)
        rec.info["power_products"] = self.power_products
        return rec

    # -- counts --------------------------------------------------------------

    def flops(self, rec: Record) -> int:
        p = self.ctx.problem
        sparse = fl.sparse_step(*self._b1_launch())
        fit = lip.fit_flops_per_iteration(p["height"], p["width"], p["bands"], **self._net())
        return sum(sparse + n * fit for n in rec.info["dip_iters"])

    # -- the check -----------------------------------------------------------

    def _ref_fit(self, start, pr, c: int, k: int, n_iters=None):
        return lip.dip_prox(start, pr, self.ctx.setup, self.init(c, k), n_iters, self.ctx.cfg.ln_lambda,
                            self._net()["power_iters"])

    def _program_first_forward(self, c: int) -> torch.Tensor:
        """The program's DIP output (P, B) of outer step 0 of cube ``c`` with
        a one-iteration fit, from the second of two runs (the replay)."""
        ctx = self.ctx
        cfg = dataclasses.replace(ctx.cfg, dip=dataclasses.replace(ctx.cfg.dip, num_iter=1))
        noisy, mask = self.pool[c]
        solver = program.Solver(program.HsiSample(noisy=noisy, mask=mask), ctx.dictionary, cfg,
                                device=ctx.device, dip_init=lambda itr: self.init(c, 0))
        outs = []
        for _ in range(2):
            solver.run(n_iters=1, state=solver.init_state(), callback=lambda i, st, aux: outs.append(aux.U))
        return outs[-1]

    def readings(self, control: bool = False) -> dict:
        """``cube_steps``'s readings (the widest ``state_gap``, the median
        ``fit_loss_excess`` and ``fit_u_gap``) with the 1-Lip fit, and
        ``net_gap``: the program's first forward (or, with ``control``, the
        reference's in TF32) against the reference's in float32."""
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
                fit, n = self._ref_fit(start, pr, c, k)
            if control:
                with reference_precision(ctx.device, tf32=True):
                    got = ref.finish(start, pr, ref.sparse_stage(start, pr, ctx.setup), U, ctx.setup)
                    got_fit = self._ref_fit(start, pr, c, k).out
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
        start = ref.initial_state(pr)
        with reference_precision(ctx.device, tf32=False):
            first = self._ref_fit(start, pr, c, 0, n_iters=1).out
        if control:
            with reference_precision(ctx.device, tf32=True):
                got_first = self._ref_fit(start, pr, c, 0, n_iters=1).out
        else:
            got_first = self._program_first_forward(c)
        return {"state_gap": state_gap, "fit_loss_excess": float(np.median(excess)),
                "fit_u_gap": float(np.median(rels)), "net_gap": gap(got_first, first)}
