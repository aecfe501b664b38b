#!/usr/bin/env python3
"""Time kernel B1 through its wrapper on the card, for any tree of the port.

    python scripts/time_b1.py [--root DIR] [--label NAME] [--reps 7] [--shapes main|wide|long|all]
    python scripts/time_b1.py --tiers [--library] [--shapes panel]

Times ``pnp_ista_blocks_fused`` (100 iterations, trace4 alpha) as the median
of ``--reps`` CUDA-event timings after 2 warm-ups, and prints one JSON line
per timing with the card's name and power limit.  ``--shapes main`` (the
default): the shipped dictionary and masks of synthetic_sample at nB 144
(36x36 crop) and nB 2304 (144x144 cube), with f32 and bf16 operands;
``wide``: at nB 144 each shape of that tree's ``chip_smoke.WIDE_SHAPES`` (the
shapes of the streamed kernel, random dictionaries from
``chip_smoke.wide_problem``) with its operand types; ``long``: at nB 144 each
shape of this tree's ``chip_smoke.LONG_K_SHAPES`` (the long-K tail past the
streamed tier's columns, problems from that tree's ``wide_problem``), and
P 256 / K 3000 at nB 13 with 20 iterations (this tree's
``chip_smoke.long_k_problem``); ``all``: main and wide.  The long shape list is read from this
tree's chip_smoke.py whatever ``--root`` says, so that a tree without it is
timed at the same shapes.  Each line also gives the tier, the bound
(``bound_ms``, this tree's ``chip_smoke.bound_ms``) and, with ``--library``,
the 200 ``torch.matmul`` calls of the two products at the shape
(``library_ms``).  ``--root`` names another checkout of the
repository (for example the parent commit unpacked with ``git archive``) whose
package and chip_smoke.py are imported in place of this one's, so that two
versions of the kernel are timed by one command on one card:

    python scripts/time_b1.py --root archive/parent --label parent
    python scripts/time_b1.py --label change

``--tiers`` times every candidate tiling of ``plan_candidates`` (one per
tier that takes the shape, two of the panel tier) at each shape of ``ista_cuda.SWEPT_SHAPES``
(random problems from ``chip_smoke.tier_problem``, 100 iterations): the
candidates take turns, 2 warm-ups and ``--reps`` rounds each (``chip_smoke.time_candidates``), and each line gives the
candidate's tiling, its median and all its times, its max |delta| from the
plain loop, whether ``plan_ista`` picks it, its predicted time
(``ista_cuda.predicted_ms``), the bound and, with ``--library``, the
yardstick.  With ``--shapes panel`` only the shapes where the panel tier
is a candidate (many rows) are swept, every tier there in turns.  The
plan's constants are fitted to these lines (``scripts/fit_b1_plan.py``); a
shape added to ``SWEPT_SHAPES`` is swept before the sweeps are committed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _this_trees_chip_smoke():
    """This tree's chip_smoke.py, loaded under another name so that
    ``--root``'s stays importable as ``chip_smoke``."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_tree", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _library_ms(nB: int, P: int, D, n_iter: int, mm: str, time_cuda) -> float:
    """The 2 n_iter torch.matmul calls of B1's two products at the shape."""
    import torch

    dt = torch.float32 if mm == "float32" else torch.bfloat16
    x = torch.zeros((nB, D.shape[1]), device="cuda", dtype=dt)
    r = torch.zeros((nB, P), device="cuda", dtype=dt)
    Dm = D.to(dt)

    def matmuls():
        for _ in range(n_iter):
            torch.matmul(x, Dm.T)
            torch.matmul(r, Dm)

    return time_cuda(matmuls)


def _tiers(here, args, smi: str) -> int:
    """The ``--tiers`` sweep (module docstring)."""
    import dataclasses

    from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, pnp_ista_blocks, pnp_ista_blocks_fused
    from lrs_pnp_dip_tpu_torch.ops.cuda_kernel import MAX_SMEM_BYTES
    from lrs_pnp_dip_tpu_torch.ops.ista_cuda import SWEPT_SHAPES, plan_candidates, predicted_ms
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    n_iter = 100
    for nB, P, K in sorted({shape[:3] for shape in SWEPT_SHAPES}):
        problem = here.tier_problem(nB, P, K)
        for bf16 in (False, True):
            if (nB, P, K, bf16) not in SWEPT_SHAPES:
                continue
            mm = "bfloat16" if bf16 else "float32"
            cfg = SparseProxConfig(n_iter=n_iter, matmul_dtype=mm)
            plans = plan_candidates(nB, P, K, bf16, ISTA_KERNEL.resident_clusters(bf16), MAX_SMEM_BYTES)
            if args.shapes == "panel" and not any(p.tier == "panel" for p in plans):
                continue
            pick = ISTA_KERNEL.plan(nB, P, K, bf16)
            ref = pnp_ista_blocks(*problem[:3], cfg, alpha=problem[3])
            errs = []
            for plan in plans:
                with ISTA_KERNEL.forcing(plan):
                    errs.append(float((pnp_ista_blocks_fused(*problem[:3], cfg, alpha=problem[3]) - ref).abs().max()))
            timed = here.time_candidates(*problem[:3], problem[3], cfg, plans, reps=args.reps)
            library = here.matmul_yardstick_ms(nB, problem[2], n_iter, mm) if args.library else None
            for plan, err, (ms, times) in zip(plans, errs, timed):
                row = {
                    "label": args.label, "card": smi, "nB": nB, "P": P, "K": K, "operands": mm, "n_iter": n_iter,
                    **{k: v for k, v in dataclasses.asdict(plan).items() if k not in ("nB", "P", "K", "bf16")},
                    "waves": plan.waves, "l2_bytes_per_iteration": plan.l2_bytes_per_iteration,
                    "pick": plan == pick, "predicted_ms": predicted_ms(plan, n_iter), "ms": ms, "times": times,
                    "max_abs_err_vs_plain": err, "max_ref": float(ref.abs().max()),
                    "bound_ms": here.bound_ms(nB, P, K, n_iter, mm, here.H100_PEAKS)[0], "library_ms": library,
                }
                print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--shapes", choices=("main", "wide", "long", "all", "panel"), default="main",
                    help="panel: with --tiers, only the shapes the panel tier takes")
    ap.add_argument("--library", action="store_true", help="also time the 200 torch.matmul yardstick")
    ap.add_argument("--tiers", action="store_true", help="time every tier's tiling at ista_cuda.SWEPT_SHAPES")
    args = ap.parse_args()
    here = _this_trees_chip_smoke()  # its bound, and its list of long-K shapes
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("time_b1: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from lrs_pnp_dip_tpu_torch.data import load_trained_dictionary
    from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, pnp_ista_blocks, pnp_ista_blocks_fused
    from lrs_pnp_dip_tpu_torch.utils import resolve_device
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    ISTA_KERNEL.build()
    if args.tiers:
        return _tiers(here, args, smi)
    cases = []
    if args.shapes in ("main", "all"):
        D_np = load_trained_dictionary(512)
        cases += [(lambda side=side, seed=seed: chip_smoke.problem(side, side, seed, D_np), ("float32", "bfloat16"), 100)
                  for side, seed in ((36, 0), (144, 1))]
    if args.shapes in ("wide", "all"):
        cases += [(lambda block=block, K=K: chip_smoke.wide_problem(block, K), types, 100)
                  for block, K, types in chip_smoke.WIDE_SHAPES]
    if args.shapes == "long":
        cases += [(lambda block=block, K=K: chip_smoke.wide_problem(block, K), types, 100)
                  for block, K, types in here.LONG_K_SHAPES]
        cases.append((here.long_k_problem, ("float32",), 20))
    for make, types, n_iter in cases:
        blocks, masks, D, alpha = make()
        nB, P = blocks.shape
        K = D.shape[1]
        for mm in types:
            cfg = SparseProxConfig(n_iter=n_iter, matmul_dtype=mm)
            got = pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha)
            err = float((got - pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha)).abs().max())
            ms = chip_smoke.time_cuda(
                lambda: pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha), reps=args.reps
            )
            row = {
                "label": args.label, "card": smi, "nB": nB, "P": P, "K": K, "operands": mm, "n_iter": n_iter,
                "tier": ISTA_KERNEL.last_plan.tier, "ms": ms, "max_abs_err_vs_plain": err,
                "bound_ms": here.bound_ms(nB, P, K, n_iter, mm, here.H100_PEAKS)[0],
            }
            if args.library:
                row["library_ms"] = _library_ms(nB, P, D, n_iter, mm, chip_smoke.time_cuda)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
