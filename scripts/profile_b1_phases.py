#!/usr/bin/env python3
"""Where kernel B1's time goes inside one iteration, on the card.

    python scripts/profile_b1_phases.py [--n-iter 100] [--cluster 8|16] [--stage-rows 8|16] [--shapes main|long|all|panel]

Builds csrc/ista.cu a second time with -DISTA_PROFILE, which makes thread 0
of CTA 0 add up the clock cycles of each phase of an iteration, and prints
cycles and microseconds per iteration for each phase beside the call's time
from CUDA events, at nB 144:

- the main-path problem (the shipped dictionary, synthetic_sample masks,
  trace4 alpha) on the resident kernels, f32 and bf16;
- block 40 (P 1600, K 512) and P 1296 / K 1024 in f32 and P 576 / K 1152 in
  bf16 on the streamed kernel (chip_smoke.wide_problem's random dictionaries);
- with ``--shapes long`` (or ``all``, both lists) instead, each shape of
  ``chip_smoke.LONG_K_SHAPES`` on the column kernel, with its operand types;
- with ``--shapes panel`` instead, nB 1152 and 2304 at P 1296 / K 512 (random
  problems, ``chip_smoke.tier_problem``), f32 and bf16, each panel tiling
  (clusters of 8 and of 16) forced.

``--cluster`` keeps the plan to clusters of that size (the card is told to
keep none of the other), and ``--stage-rows`` sets the f32 streamed kernel's
stage height, to compare the tilings of the streamed kernel.
The counters cost a few clock reads per iteration; the production build has
none of them.  In the streamed kernel the phases interleave (each step of
its pipeline runs product 1 of one stage, the residual of the one before and
product 2 of the one before that), so each phase's sum is its share of the
whole pass.  In the column kernel a cluster sync's time is thread 0's wait
for the slowest CTA of its cluster.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PHASES = {
    "resident": (
        "product 1 (x D_c^T)", "sum of warps, residual", "product 2 (r_c D_c)",
        "cluster.sync 1", "pull partials, g", "NLM", "push x", "cluster.sync 2",
    ),
    "streamed": (
        "product 1 (x D_s^T)", "sum of warps, residual", "product 2 (r_s D_s)",
        "stage waits, barriers", "pull partials, g", "NLM", "push x", "g out, cluster syncs",
    ),
    "column": (
        "product 1 (x_c D_c^T)", "cluster.sync 1", "sum partials, residual", "cluster.sync 2",
        "product 2 (r D_c), g", "cluster.sync 3", "halo, NLM",
    ),
    "panel": (
        "product 1, residual, fill", "G to shared memory", "product 2 (r_s D_s)", "stage waits",
        "pull partials, g", "NLM", "push x", "cluster syncs",
    ),
}


def main() -> int:
    import torch

    import chip_smoke
    from lrs_pnp_dip_tpu_torch.data import load_trained_dictionary
    from lrs_pnp_dip_tpu_torch.ops import ista, ista_cuda
    from lrs_pnp_dip_tpu_torch.ops.ista_cuda import FusedIstaKernel
    from lrs_pnp_dip_tpu_torch.utils import resolve_device
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--n-iter", type=int, default=100)
    ap.add_argument("--cluster", type=int, choices=(8, 16), default=None)
    ap.add_argument("--stage-rows", type=int, choices=(8, 16), default=None)
    ap.add_argument("--nvcc-flag", action="append", default=[], help="a further flag for the build")
    ap.add_argument("--shapes", choices=("main", "long", "all", "panel"), default="main")
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
    cases = []
    if args.shapes in ("main", "all"):
        main_problem = chip_smoke.problem(36, 36, 0, load_trained_dictionary(512))
        cases += [(main_problem, "float32"), (main_problem, "bfloat16"),
                  (chip_smoke.wide_problem(40, 512), "float32"), (chip_smoke.wide_problem(36, 1024), "float32"),
                  (chip_smoke.wide_problem(24, 1152), "bfloat16")]
    if args.shapes in ("long", "all"):
        for block, K, types in chip_smoke.LONG_K_SHAPES:
            problem = chip_smoke.wide_problem(block, K)
            cases += [(problem, mm) for mm in types]
    cases = [(problem, mm, None) for problem, mm in cases]
    if args.shapes == "panel":
        for nB in (1152, 2304):
            problem = chip_smoke.tier_problem(nB, 1296, 512)
            for mm in ("float32", "bfloat16"):
                cases += [(problem, mm, plan) for plan in ista_cuda.plan_candidates(nB, 1296, 512, mm == "bfloat16")
                          if plan.tier == "panel"]

    kernel = FusedIstaKernel(extra_flags=("-DISTA_PROFILE", *args.nvcc_flag))
    lib = kernel.build()
    for line in kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    if args.cluster:
        for bf16 in (False, True):
            counts = kernel.resident_clusters(bf16)
            kernel._resident[bf16] = {C: (n if C == args.cluster else 0) for C, n in counts.items()}
    if args.stage_rows:
        ista_cuda._STAGE_ROWS[False] = (args.stage_rows,)
    lib.lrs_pnp_ista_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.lrs_pnp_ista_phase_cycles.restype = ctypes.c_int
    cycles = (ctypes.c_longlong * 8)()
    # the counters tick at the SM clock; microseconds are given at its maximum
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", 1980000)
    ista.ISTA_KERNEL, production = kernel, ista.ISTA_KERNEL
    try:
        for (blocks, masks, D, alpha), mm, forced in cases:
            cfg = SparseProxConfig(n_iter=args.n_iter, matmul_dtype=mm)

            def run():
                with kernel.forcing(*(() if forced is None else (forced,))):
                    return ista.pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha)
            run()
            torch.cuda.synchronize()
            lib.lrs_pnp_ista_phase_cycles(cycles)  # zero
            run()
            torch.cuda.synchronize()
            if lib.lrs_pnp_ista_phase_cycles(cycles) != 0:
                raise RuntimeError("reading the phase counters failed")
            ms = chip_smoke.time_cuda(run)
            err = float((run() - ista.pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha)).abs().max())
            plan = forced or kernel.plan(blocks.shape[0], blocks.shape[1], D.shape[1], mm == "bfloat16")
            print(f"P {plan.P}, K {plan.K}, {mm}: {ms:.4f} ms per call, max|delta| {err:.3e} from the plain "
                  f"loop; {chip_smoke.describe_plan(plan)}")
            names = PHASES[plan.tier]
            total = sum(cycles[: len(names)])
            for name, c in zip(names, cycles):
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
