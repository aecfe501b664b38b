"""Tiles returned to the host over the window's length (a cube is one tile)."""


def read(run):
    tiles = sum(r.tiles for r in run.records)
    return tiles / run.window_s if tiles else None
