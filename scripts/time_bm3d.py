#!/usr/bin/env python3
"""Time ``bm3d_prox`` at a scene size: the port's fixed-order aggregation
against the ``index_add_`` aggregation it replaced, on the card and on the
CPU.

    python scripts/time_bm3d.py [--size 144] [--bands 128] [--cpu-bands 128] [--reps 3]

On the noisy cube of ``synthetic_sample(size, size, bands)`` at sigma 0.12,
for each formulation: ms per call (on the card the median of ``--reps``
CUDA-event timings after one warm-up, with its peak of allocated device
memory; on the CPU the wall time of one call after none, over
``--cpu-bands`` bands), whether two calls give equal bits, the longest run
of group members per patch (the passes of ``ops/bm3d.py:_segment_sum``),
and the relative L2 distance between the two formulations' outputs.  The
``index_add_`` formulation is built here and nowhere in the package.
Prints one JSON line per device with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path


def _index_add_aggregate(filtered, weights, idx, geo, shape):
    """The aggregation before it was put in a fixed order: ``index_add_``
    over group membership, then onto the pixel grid."""
    import torch

    N, nP, g = idx.shape
    p2 = geo.p * geo.p
    dev = filtered.device
    seg = (idx + nP * torch.arange(N, device=dev)[:, None, None]).reshape(-1)
    vals = (filtered * weights[:, :, None, None, None]).reshape(N * nP * g, p2)
    wrep = weights[:, :, None].expand(N, nP, g).reshape(-1)
    patch_num = torch.zeros((N * nP, p2), device=dev).index_add_(0, seg, vals)
    patch_den = torch.zeros(N * nP, device=dev).index_add_(0, seg, wrep)
    pix = geo.pix.reshape(-1)
    H, W = shape
    num = torch.zeros((N, H * W), device=dev).index_add_(1, pix, patch_num.reshape(N, -1))
    den = torch.zeros((N, H * W), device=dev).index_add_(
        1, pix, patch_den.reshape(N, nP, 1).expand(N, nP, p2).reshape(N, -1)
    )
    return num.reshape(N, H, W), den.reshape(N, H, W)


@contextlib.contextmanager
def _formulation(name: str, runs: list):
    """``bm3d``'s aggregation as ``name`` ("fixed_order" or "index_add");
    the longest run of members per patch of each call goes to ``runs``."""
    import importlib

    import torch

    mod = importlib.import_module("lrs_pnp_dip_tpu_torch.ops.bm3d")
    saved = mod._aggregate, mod._segment_sum

    def segment_sum(vals, seg, n_seg):
        runs.append(int(torch.stack([torch.bincount(s, minlength=n_seg) for s in seg]).max()))
        return saved[1](vals, seg, n_seg)

    mod._segment_sum = segment_sum
    if name == "index_add":
        mod._aggregate = _index_add_aggregate
    try:
        yield
    finally:
        mod._aggregate, mod._segment_sum = saved


def _measure(cube, dev: str, reps: int) -> dict:
    import torch

    from lrs_pnp_dip_tpu_torch.ops import bm3d_prox

    x = cube.to(dev)
    out = {}
    for name in ("fixed_order", "index_add"):
        runs: list = []
        with _formulation(name, runs):
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                first = bm3d_prox(x, 0.12)
                times = []
                for _ in range(reps):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    again = bm3d_prox(x, 0.12)
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
                ms = sorted(times)[len(times) // 2]
                peak = torch.cuda.max_memory_allocated()
            else:
                t0 = time.perf_counter()
                first = bm3d_prox(x, 0.12)
                ms = (time.perf_counter() - t0) * 1e3
                again = bm3d_prox(x, 0.12)
                peak = None
        out[name] = dict(ms=ms, peak_bytes=peak, repeats=bool(torch.equal(first, again)),
                         longest_run=max(runs) if runs else None, result=first.cpu())
    a, b = out["fixed_order"].pop("result"), out["index_add"].pop("result")
    out["relative_l2"] = float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=144)
    ap.add_argument("--bands", type=int, default=128)
    ap.add_argument("--cpu-bands", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

    import torch

    from lrs_pnp_dip_tpu_torch.data import synthetic_sample

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cube = torch.from_numpy(synthetic_sample(args.size, args.size, args.bands, seed=0).noisy)
    card = None
    if torch.cuda.is_available():
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        print(json.dumps({"device": "cuda", "card": card, "shape": list(cube.shape),
                          **_measure(cube, "cuda", args.reps)}), flush=True)
    cpu_cube = cube[:, :, : args.cpu_bands]
    print(json.dumps({"device": "cpu", "threads": torch.get_num_threads(), "host_of": card,
                      "shape": list(cpu_cube.shape), **_measure(cpu_cube, "cpu", args.reps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
