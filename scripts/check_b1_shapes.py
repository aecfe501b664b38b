#!/usr/bin/env python3
"""Check and time kernel B1 on the card at the shapes that take its
streamed kernel, beside the main shape.

    python scripts/check_b1_shapes.py [--reps 5] [--no-plain]

At nB 144, 100 iterations, trace4 alpha, for the main shape with the
shipped dictionary and for each shape of ``chip_smoke.WIDE_SHAPES`` (the
one list of streamed shapes), f32 and bf16 where listed: the kernel against its plain
loop (chip_smoke.py's tolerances: in bf16 at the streamed shapes the larger
of BF16_MATCH and BF16_ORDER_FACTOR times the plain loop's own order
sensitivity, as its phase 2), two launches with equal bits, the plan,
and the kernel's time (median of CUDA-event timings) beside its bound and,
unless ``--no-plain``, the plain loop's.  Prints one JSON line per shape and
operand type with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-plain", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

    import torch

    if not torch.cuda.is_available():
        print("check_b1_shapes: no CUDA device is available", file=sys.stderr)
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
    for line in ISTA_KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    peaks = chip_smoke.peaks_for(torch.cuda.get_device_name(0))
    for block, K, types in ((36, 512, ("float32", "bfloat16")),) + chip_smoke.WIDE_SHAPES:
        if (block, K) == (36, 512):
            inputs = chip_smoke.problem(36, 36, 0, load_trained_dictionary(512))
        else:
            inputs = chip_smoke.wide_problem(block, K)
        blocks, masks, D, alpha = inputs
        nB, P = blocks.shape
        bf16_match = chip_smoke.BF16_MATCH
        if (block, K) != (36, 512):
            bf16_match = max(bf16_match, chip_smoke.BF16_ORDER_FACTOR * chip_smoke.order_sensitivity(*inputs))
        for mm in types:
            err = chip_smoke.check_kernel(*inputs, mm, bf16_match=bf16_match)
            chip_smoke.check_same_bits(*inputs, mm)
            cfg = SparseProxConfig(n_iter=100, matmul_dtype=mm)
            ms = chip_smoke.time_cuda(lambda: pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha), reps=args.reps)
            plain = None if args.no_plain else chip_smoke.time_cuda(
                lambda: pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha), warmup=1, reps=3)
            b_ms, by, _, _ = chip_smoke.bound_ms(nB, P, K, 100, mm, peaks)
            plan = ISTA_KERNEL.plan(nB, P, K, mm == "bfloat16")
            print(json.dumps({
                "card": smi, "nB": nB, "P": P, "K": K, "operands": mm, "n_iter": 100, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": by, "max_abs_err_vs_plain": err,
                "plan": chip_smoke.describe_plan(plan),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
