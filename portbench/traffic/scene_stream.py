"""Traffic ``scene_stream``: a closed loop of one client calling
``api.inpaint_scene`` at its defaults (``tile``-pixel tiles, ``tile_batch``
of them in lockstep, ``scan=True`` for ``lrs_pnp``) on scenes taken
round-robin from a pool made from the seed; a request ends when the
stitched scene is a numpy array on the host.  Every answer of the window is
compared with the reference's tile-by-tile solve of its scene."""

from __future__ import annotations

import program
from reference import solver as ref
from yardstick import flops as fl
from yardstick import inputs

from .base import Context, Record, Reservoir, blocks_per_cube, gap, now, pool, reference_precision


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        # (pool index, answer) of a sample of the window's requests drawn from the seed
        self.answers = Reservoir(ctx.cell["checked_answers"], inputs.sub_seeds(ctx.seed, 1, inputs.ANSWER_SAMPLE)[0])
        c = ctx.cell
        self.tile = tuple(c["tile"])
        self.n_tiles = len(ref.starts(c["height"], self.tile[0], self.tile[0])) * len(
            ref.starts(c["width"], self.tile[1], self.tile[1]))

    def setup(self) -> None:
        c = self.ctx.cell
        self.pool = pool(self.ctx, c["pool"], c["height"], c["width"])
        self._call(0)  # warm-up: one request builds B1 and captures both graphs

    def _call(self, j: int):
        noisy, mask, _ = self.pool[j]
        return program.inpaint_scene(
            noisy, mask, variant=self.ctx.cfg.variant, config=self.ctx.cfg, dictionary=self.ctx.dictionary,
            tile_shape=self.tile, tile_batch=self.ctx.cell["tile_batch"], device=self.ctx.device)

    def request(self, i: int) -> Record:
        j = i % len(self.pool)
        t0 = now()
        scene = self._call(j)
        t1 = now()
        self.answers.offer((j, scene))
        return Record(t0, t1, tiles=self.n_tiles, steps=self.ctx.cfg.outer_iters, info={})

    def traced(self) -> None:
        for i in range(self.ctx.cell["trace_requests"]):
            self._call(i % len(self.pool))

    def release(self) -> None:
        pass

    def _tile_blocks(self) -> int:
        return blocks_per_cube(self.ctx, *self.tile)

    def flops(self, rec: Record) -> int:
        p = self.ctx.problem
        return rec.tiles * fl.lrs_pnp_tile(self.ctx.setup, *self.tile, p["bands"], p["atoms"],
                                           self._tile_blocks(), rec.steps)

    def traced_b1_work(self) -> list:
        """[(nB, P, K, n_iter)]: B1's work in the traced stretch, one entry
        per batch of tiles and outer step of each request."""
        s, batch = self.ctx.setup, self.ctx.cell["tile_batch"]
        lanes = [min(batch, self.n_tiles - i) for i in range(0, self.n_tiles, batch)]
        per_request = [(n * self._tile_blocks(), s.block_size ** 2, self.ctx.problem["atoms"], s.n_iter)
                       for n in lanes] * self.ctx.cfg.outer_iters
        return per_request * self.ctx.cell["trace_requests"]

    def _reference(self, j: int, tf32: bool):
        noisy, mask, _ = self.pool[j]
        with reference_precision(self.ctx.device, tf32):
            return ref.solve_scene(noisy, mask, self.ctx.dictionary, self.ctx.setup, self.ctx.cfg.outer_iters,
                                   self.tile, self.ctx.device)

    def readings(self, control: bool = False) -> dict:
        """``x_gap``: the widest gap of any answer of the window (or, with
        ``control``, of the reference's solve in TF32 of each scene the
        window asked for) from the reference's solve of its scene."""
        used = sorted({j for j, _ in self.answers.items})
        want = {j: self._reference(j, tf32=False) for j in used}
        if control:
            return {"x_gap": max(gap(self._reference(j, tf32=True), want[j]) for j in used)}
        return {"x_gap": max(gap(a, want[j]) for j, a in self.answers.items)}
