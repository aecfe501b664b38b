"""Faults planted in the program underneath a run, to show that ``correct``
sees them: ``test_faults.py`` plants each in a whole run on the CPU, and
``control.py --fault <name>`` on the card, where the readings of the
faults that set an upper reading are taken.

Each fault is ``fault(patch)``, where ``patch(owner, name, value)`` sets an
attribute as ``monkeypatch.setattr`` does."""

from __future__ import annotations

import dataclasses

import program  # noqa: F401  (puts the port on the path)
from lrs_pnp_dip_tpu_torch.solvers import admm, dip, tiled


def unchanged_state(patch) -> None:
    """A step that returns its state unchanged (the counter still moves)."""
    finish = admm.OuterStages.finish

    def same_state(self, state, consts, *args):
        new, aux = finish(self, state, consts, *args)
        return state._replace(itr=new.itr), aux

    patch(admm.OuterStages, "finish", same_state)


def altered_state(patch) -> None:
    """An answer altered where it is produced: one pixel's spectrum of X."""
    finish = admm.OuterStages.finish

    def altered(self, state, consts, *args):
        new, aux = finish(self, state, consts, *args)
        X = new.X.clone()
        X[..., 7, :] += 0.05
        return new._replace(X=X), aux

    patch(admm.OuterStages, "finish", altered)


def altered_scene(patch) -> None:
    """An answer altered where it is produced: one pixel of the stitched scene."""
    solve = tiled.solve_tiled

    def altered(*args, **kw):
        scene = solve(*args, **kw).copy()
        scene[40, 50, :] += 0.05
        return scene

    patch(tiled, "solve_tiled", altered)


def half_batch(patch) -> None:
    """Half of each batch of tiles left out."""
    batches = tiled.TileLoader.batches

    def half(self):
        for tiles, origins in batches(self):
            n = max(1, len(origins) // 2)
            yield tiles[:n], origins[:n]

    patch(tiled.TileLoader, "batches", half)


def frozen_fit(patch) -> None:
    """The DIP fit's state left unchanged: Adam never updates the net, so
    every iteration returns the initial weights' output."""
    patch(dip.DipFit, "_adam", lambda self, grads, active, i: None)


def cut_fit(patch) -> None:
    """The DIP fit stopped after its first chunk of ``FIT_CHUNK`` iterations."""
    init = dip.DipFit.__init__

    def cut(self, model, cfg=dip.DipConfig()):
        init(self, model, dataclasses.replace(cfg, num_iter=min(cfg.num_iter, dip.FIT_CHUNK)))

    patch(dip.DipFit, "__init__", cut)


def window_last(patch) -> None:
    """The DIP fit returns its last output where the configuration asks for
    the mean of its window (``return_mode`` left at ``last``)."""
    init = dip.DipFit.__init__

    def last(self, model, cfg=dip.DipConfig()):
        init(self, model, dataclasses.replace(cfg, return_mode="last"))

    patch(dip.DipFit, "__init__", last)


FAULTS = {f.__name__: f for f in (unchanged_state, altered_state, altered_scene, half_batch, frozen_fit, cut_fit,
                                  window_last)}
