#!/usr/bin/env python3
"""Time the two ways to bring a stitched scene from the card to the host,
in turns, at the `lrs_pnp` cells' scene shape (144x144x128 float32).

    python scripts/time_stitch_readback.py [--reps 100] [--calls 20] [--out FILE]

``pageable``: ``scene.cpu().numpy()``, one device-to-host copy into a fresh
array (``solvers/tiled.py:_TileEngine.to_host``).  ``pinned``: one copy into
a page-locked buffer kept for the shape, then one host copy into a fresh
array.  First the copy alone: each rep copies a scene that the card has
just written, after a sync, the two routes in alternating order, and keeps
its answer among the latest 32, as the benchmark's reservoir of answers
does, so each route pays for its fresh pages as a caller would.  Then
``solve_tiled`` at the preset (one 144x144 tile, and 16 tiles of 36x36 in
batches of 8), each call with the other route than the last, ``--calls``
calls a route, with the counters ``placed`` and ``readbacks``.  Prints one
JSON line with the card's name and power limit and the times in ms
(median, min, max).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lrs_pnp_dip_tpu_torch.data import random_dictionary, synthetic_sample  # noqa: E402
from lrs_pnp_dip_tpu_torch.solvers import tiled  # noqa: E402
from lrs_pnp_dip_tpu_torch.utils.config import lrs_pnp_preset  # noqa: E402

SHAPE = (144, 144, 128)


_STAGING = {}


def _pinned(engine, scene: torch.Tensor) -> np.ndarray:
    engine.readbacks += 1
    if scene.shape not in _STAGING:
        _STAGING[scene.shape] = torch.empty(scene.shape, dtype=scene.dtype, pin_memory=True)
    return _STAGING[scene.shape].copy_(scene).numpy().copy()


ROUTES = {"pageable": tiled._TileEngine.to_host, "pinned": _pinned}


def _card() -> dict:
    query = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": query.stdout.strip()}


def _summary(times) -> dict:
    return {"median": statistics.median(times), "min": min(times), "max": max(times), "n": len(times)}


def _turns(i: int):
    names = list(ROUTES)
    return names if i % 2 == 0 else names[::-1]


def time_copies(engine, reps: int) -> dict:
    scene = torch.empty(SHAPE, dtype=torch.float32, device="cuda")
    kept = {name: [] for name in ROUTES}
    times = {name: [] for name in ROUTES}
    for i in range(reps):
        for name in _turns(i):
            scene.normal_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answer = ROUTES[name](engine, scene)
            times[name].append((time.perf_counter() - t0) * 1e3)
            kept[name] = (kept[name] + [answer])[-32:]
    want = scene.cpu().numpy()
    assert all(np.array_equal(route(engine, scene), want) for route in ROUTES.values())
    return {name: _summary(t) for name, t in times.items()}


def time_solves(calls: int) -> dict:
    cfg = lrs_pnp_preset()
    D = random_dictionary(1296, 512, seed=1)
    scene = synthetic_sample(*SHAPE, missing=0.05, seed=7)
    out = {}
    for tile, batch in (((144, 144), 1), ((36, 36), 8)):
        kw = dict(tile_shape=tile, tile_batch=batch, device="cuda")
        answers = {}
        times = {name: [] for name in ROUTES}
        tiled.solve_tiled(scene.noisy, scene.mask, D, cfg, **kw)  # warm-up: builds and captures
        engine = tiled._tiled_engine(cfg, (*tile, SHAPE[2]), None, torch.device("cuda"))
        for i in range(calls):
            for name in _turns(i):
                tiled._TileEngine.to_host = ROUTES[name]
                t0 = time.perf_counter()
                answers[name] = tiled.solve_tiled(scene.noisy, scene.mask, D, cfg, **kw)
                times[name].append((time.perf_counter() - t0) * 1e3)
                assert (engine.placed, engine.readbacks) == ((144 // tile[0]) * (144 // tile[1]), 1)
        tiled._TileEngine.to_host = ROUTES["pageable"]
        assert np.array_equal(answers["pinned"], answers["pageable"])
        out[f"{tile[0]}x{tile[1]}_batch{batch}"] = {
            **{name: _summary(t) for name, t in times.items()},
            "placed": engine.placed, "readbacks": engine.readbacks}
    return out, engine


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    solves, engine = time_solves(args.calls)
    line = json.dumps({**_card(), "shape": SHAPE, "copy_ms": time_copies(engine, args.reps),
                       "solve_tiled_ms": solves})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
