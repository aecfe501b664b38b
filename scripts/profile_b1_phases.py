#!/usr/bin/env python3
"""Where kernel B1's time goes inside one iteration, on the card.

    python scripts/profile_b1_phases.py [--nB 144] [--n-iter 100]

Builds csrc/ista.cu a second time with -DISTA_PROFILE, which makes thread 0
of CTA 0 add up the clock cycles of each phase of an iteration, runs the
main-path problem (the shipped dictionary, synthetic_sample masks, trace4
alpha) with f32 and with bf16 operands, and prints cycles and microseconds
per iteration for each phase beside the call's time from CUDA events.  The
counters cost a few clock reads per iteration; the production build has
none of them.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PHASES = (
    "product 1 (x D_c^T)", "sum of warps, residual", "product 2 (r_c D_c)",
    "cluster.sync 1", "pull partials, g", "NLM", "push x", "cluster.sync 2",
)


def main() -> int:
    import torch

    import chip_smoke
    from lrs_pnp_dip_tpu_torch.data import load_trained_dictionary
    from lrs_pnp_dip_tpu_torch.ops import ista
    from lrs_pnp_dip_tpu_torch.ops.ista_cuda import FusedIstaKernel
    from lrs_pnp_dip_tpu_torch.utils import resolve_device
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--nB", type=int, default=144)
    ap.add_argument("--n-iter", type=int, default=100)
    ap.add_argument("--nvcc-flag", action="append", default=[], help="a further flag for the build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_b1_phases: no CUDA device is available", file=sys.stderr)
        return 1
    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card {smi}")
    side = 36 if args.nB <= 144 else 144
    blocks, masks, D, alpha = chip_smoke.problem(side, side, 0, load_trained_dictionary(512))
    blocks, masks, alpha = blocks[: args.nB], masks[: args.nB], alpha[: args.nB]

    kernel = FusedIstaKernel(extra_flags=("-DISTA_PROFILE", *args.nvcc_flag))
    lib = kernel.build()
    lib.lrs_pnp_ista_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.lrs_pnp_ista_phase_cycles.restype = ctypes.c_int
    cycles = (ctypes.c_longlong * 8)()
    # the counters tick at the SM clock; microseconds are given at its maximum
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", 1980000)
    ista.ISTA_KERNEL, production = kernel, ista.ISTA_KERNEL
    try:
        for mm in ("float32", "bfloat16"):
            cfg = SparseProxConfig(n_iter=args.n_iter, matmul_dtype=mm)
            run = lambda: ista.pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha)  # noqa: E731
            run()
            torch.cuda.synchronize()
            lib.lrs_pnp_ista_phase_cycles(cycles)  # zero
            run()
            torch.cuda.synchronize()
            if lib.lrs_pnp_ista_phase_cycles(cycles) != 0:
                raise RuntimeError("reading the phase counters failed")
            ms = chip_smoke.time_cuda(run)
            plan = kernel.plan(blocks.shape[0], blocks.shape[1], D.shape[1], mm == "bfloat16")
            print(f"{mm}: {ms:.4f} ms per call, {plan}")
            total = sum(cycles[: len(PHASES)])
            for name, c in zip(PHASES, cycles):
                per_it = c / max(args.n_iter, 1)
                print(f"  {name:26s} {per_it:9.0f} cycles per iteration "
                      f"({per_it / khz * 1e3:6.3f} us at {khz / 1e3:.0f} MHz, {c / max(total, 1):5.1%})")
            print(f"  all phases, CTA 0's cluster  {total / max(args.n_iter, 1):9.0f} cycles per iteration; "
                  f"{plan.waves} wave(s) of clusters per call")
    finally:
        ista.ISTA_KERNEL = production
    return 0


if __name__ == "__main__":
    sys.exit(main())
