#!/usr/bin/env python3
"""Time a DIP iteration of the port against the same net in its unordered
formulation, on the card: what the fits' determinism costs.

    python scripts/time_dip_formulations.py [--iters 16]

The unordered formulation, built here and nowhere in the package:
reflection padding by ``F.pad(mode="reflect")`` (``index_select`` where an
axis is no longer than the pad) and bilinear upsampling by
``F.interpolate``, whose backwards sum with atomics on the card, and the
fits and their captures without the ``deterministic_cudnn`` scope, under
cuDNN's default flags (``deterministic`` and ``benchmark`` off).  For skip-128 in f32
and bf16 and the Lipschitz U-Net at 36x36x128, each formulation's ms per
iteration host-stepped (eager) and replayed from a graph (chunk 8), over
``--iters`` iterations after a fit that sets up or captures.  Prints one JSON
line per net with the card's name and power limit.  ``chip_smoke.py`` phase
9 imports :func:`unordered_formulation` and :func:`ms_per_iteration`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

NETS = (("skip-128 f32", "dip", "float32"), ("skip-128 bf16", "dip", "bfloat16"),
        ("Lipschitz U-Net f32", "dip_1lip", "float32"))


def _unordered_pad_input(x, pad, mode):
    import torch.nn.functional as F

    from lrs_pnp_dip_tpu_torch.ops.nlm import np_pad_index

    if pad == 0:
        return x
    widths = (pad, pad) * (x.ndim - 2)
    if mode == "reflection":
        if min(x.shape[2:]) > pad:
            return F.pad(x, widths, mode="reflect")
        for axis in range(2, x.ndim):
            x = x.index_select(axis, np_pad_index(x.shape[axis], pad, "reflect", x.device))
        return x
    if mode == "replication":
        return F.pad(x, widths, mode="replicate")
    if mode == "zero":
        return F.pad(x, widths)
    raise ValueError(f"unknown pad mode {mode!r}")


def _unordered_upsample2x(x, mode="nearest"):
    import torch.nn.functional as F

    if mode == "nearest":
        return F.interpolate(x, scale_factor=2, mode="nearest")
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


@contextlib.contextmanager
def unordered_formulation():
    """Inside the block, the package's nets pad by ``F.pad`` and upsample by
    ``F.interpolate``, and its DIP fits and captures run without the
    deterministic cuDNN scope."""
    from lrs_pnp_dip_tpu_torch.models import common, lipschitz, skip
    from lrs_pnp_dip_tpu_torch.solvers.dip import DipFit
    from lrs_pnp_dip_tpu_torch.solvers.graphs import Captured

    patches = [
        (common, "pad_input", _unordered_pad_input), (lipschitz, "pad_input", _unordered_pad_input),
        (skip, "upsample2x", _unordered_upsample2x),
        (DipFit, "__call__", DipFit.__call__.__wrapped__),
        (Captured, "_capture", Captured._capture.__wrapped__),
        (Captured, "_on_side_stream", Captured._on_side_stream.__wrapped__),
    ]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    try:
        for owner, name, value in patches:
            setattr(owner, name, value)
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def ms_per_iteration(variant: str, dtype: str, iters: int, chunk, Z, target, mask) -> float:
    """ms per DIP iteration of the variant's net (a fresh one, fresh
    parameters from seed 0), the fit capped at ``iters`` with no early
    stop, after one fit that sets up (eager) or captures (``chunk``)."""
    import torch

    from lrs_pnp_dip_tpu_torch.solvers import DipFit
    from lrs_pnp_dip_tpu_torch.solvers.admm import default_net
    from lrs_pnp_dip_tpu_torch.utils.config import PRESETS

    cfg = PRESETS[variant]()
    net = default_net(cfg, Z.shape[-1]).cuda()
    fit = DipFit(net, dataclasses.replace(cfg.dip, num_iter=iters, patience=10**9, compute_dtype=dtype))
    gen = torch.Generator(device="cuda")
    fit(Z, target, mask, generator=gen.manual_seed(0), chunk=chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit(Z, target, mask, generator=gen.manual_seed(0), chunk=chunk)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=16)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    if not torch.cuda.is_available():
        print("time_dip_formulations: no CUDA device is available", file=sys.stderr)
        return 1
    from lrs_pnp_dip_tpu_torch.data import synthetic_sample
    from lrs_pnp_dip_tpu_torch.utils import resolve_device

    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sample = synthetic_sample(36, 36, 128, seed=0)
    Z = torch.from_numpy(sample.noisy).cuda()[None]
    mask = torch.from_numpy(sample.mask).cuda()[None, :, :, None].expand_as(Z).contiguous()
    for label, variant, dtype in NETS:
        row = {"card": smi, "net": label, "iters": args.iters}
        for mode, chunk in (("eager", None), ("graph", 8)):
            row[f"{mode}_ms"] = ms_per_iteration(variant, dtype, args.iters, chunk, Z, Z * mask, mask)
            with unordered_formulation():
                row[f"unordered_{mode}_ms"] = ms_per_iteration(variant, dtype, args.iters, chunk, Z, Z * mask, mask)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
