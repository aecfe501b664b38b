#!/usr/bin/env python3
"""Time kernel B1 through its wrapper on the card, for any tree of the port.

    python scripts/time_b1.py [--root DIR] [--label NAME] [--reps 7] [--shapes main|wide|all]

Times ``pnp_ista_blocks_fused`` (100 iterations, trace4 alpha) as the median
of ``--reps`` CUDA-event timings after 2 warm-ups, and prints one JSON line
per timing with the card's name and power limit.  ``--shapes main`` (the
default): the shipped dictionary and masks of synthetic_sample at nB 144
(36x36 crop) and nB 2304 (144x144 cube), with f32 and bf16 operands;
``wide``: at nB 144 each shape of that tree's ``chip_smoke.WIDE_SHAPES`` (the
shapes of the streamed kernel, random dictionaries from
``chip_smoke.wide_problem``) with its operand types; ``all``: both.  ``--root`` names another checkout of the
repository (for example the parent commit unpacked with ``git archive``) whose
package and chip_smoke.py are imported in place of this one's, so that two
versions of the kernel are timed by one command on one card:

    python scripts/time_b1.py --root archive/parent --label parent
    python scripts/time_b1.py --label change
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--shapes", choices=("main", "wide", "all"), default="main")
    args = ap.parse_args()
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
    cases = []
    if args.shapes in ("main", "all"):
        D_np = load_trained_dictionary(512)
        cases += [(lambda side=side, seed=seed: chip_smoke.problem(side, side, seed, D_np), ("float32", "bfloat16"))
                  for side, seed in ((36, 0), (144, 1))]
    if args.shapes in ("wide", "all"):
        cases += [(lambda block=block, K=K: chip_smoke.wide_problem(block, K), types)
                  for block, K, types in chip_smoke.WIDE_SHAPES]
    for make, types in cases:
        blocks, masks, D, alpha = make()
        for mm in types:
            cfg = SparseProxConfig(n_iter=100, matmul_dtype=mm)
            got = pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha)
            err = float((got - pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha)).abs().max())
            ms = chip_smoke.time_cuda(
                lambda: pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha), reps=args.reps
            )
            print(json.dumps({
                "label": args.label, "card": smi, "nB": int(blocks.shape[0]), "P": int(blocks.shape[1]),
                "K": int(D.shape[1]), "operands": mm, "n_iter": 100, "ms": ms, "max_abs_err_vs_plain": err,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
