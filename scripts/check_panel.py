#!/usr/bin/env python3
"""Kernel B1's panel tier on the card: its build and each of its tilings
against the plain loop.

    python scripts/check_panel.py [--n-iter 12]

Prints what ptxas says of the panel kernels (registers, spills, shared
memory) and how many of their clusters of 2, 4, 8 and 16 CTAs the card keeps
resident at their shared memory (K 512), then, for
nB 300 and 1153 at P 1296 / K 512 and nB 1296 at P 576 / K 512 (random
problems, ``chip_smoke.tier_problem``), with f32 and bf16 operands, each
panel tiling of ``plan_candidates`` forced in turn: max |delta| over max|ref|
against the plain loop after 1 and ``--n-iter`` iterations, and whether two
launches give equal bits; it passes at the card tests' limits (f32 1e-4 of
max|ref|; bf16 the larger of 1e-5 and 4 times the plain loop's floors,
``check_bf16_chains.floors``).  One JSON line per row, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

SHAPES = ((300, 1296, 512), (1153, 1296, 512), (1296, 576, 512))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_panel: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from check_bf16_chains import floors
    from lrs_pnp_dip_tpu_torch.ops import ista, pnp_ista_blocks
    from lrs_pnp_dip_tpu_torch.ops.cuda_kernel import MAX_SMEM_BYTES
    from lrs_pnp_dip_tpu_torch.ops.ista_cuda import plan_candidates
    from lrs_pnp_dip_tpu_torch.utils import resolve_device
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--n-iter", type=int, default=12)
    args = ap.parse_args()
    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    def emit(**row):
        print(json.dumps(dict(row, card=smi)), flush=True)

    kernel = ista.ISTA_KERNEL
    lib = kernel.build()
    function = ""
    for line in kernel.build_log.splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1]
        elif "pnp_ista_panel" in function and ("Used" in line or "spill" in line):
            emit(ptxas=line.strip(), kernel="pnp_ista_panel_" + ("bf16" if "ILb1E" in function else "f32"))
    # clusters of 2 to 16 CTAs at K 512 (seg 512 / C): the clusters the card
    # keeps resident at the panel's shared memory (minus the cudaError_t where
    # it cannot launch one)
    for bf16 in (False, True):
        for C in (2, 4, 8, 16):
            seg = 512 // C
            emit(kernel=f"panel {'bf16' if bf16 else 'f32'}", cluster_size=C,
                 resident_clusters=lib.lrs_pnp_ista_panel_max_clusters(int(bf16), C, seg),
                 smem_bytes=lib.lrs_pnp_ista_panel_smem_bytes(int(bf16), seg))

    failed = False
    for nB, P, K in SHAPES:
        problem = chip_smoke.tier_problem(nB, P, K)
        for mm in ("float32", "bfloat16"):
            bf16 = mm == "bfloat16"
            refs = {n: pnp_ista_blocks(*problem[:3], SparseProxConfig(n_iter=n, matmul_dtype=mm), alpha=problem[3])
                    for n in (1, args.n_iter)}
            limit = 1e-4
            if bf16:
                limit = floors(*problem, SparseProxConfig(n_iter=args.n_iter, matmul_dtype=mm))["limit"]
            plans = [p for p in plan_candidates(nB, P, K, bf16, kernel.resident_clusters(bf16), MAX_SMEM_BYTES)
                     if p.tier == "panel"]
            for plan in plans:
                errs, same = {}, True
                for n, ref in refs.items():
                    cfg = SparseProxConfig(n_iter=n, matmul_dtype=mm)
                    with kernel.forcing(plan):
                        got = ista.pnp_ista_blocks_fused(*problem[:3], cfg, alpha=problem[3])
                        again = ista.pnp_ista_blocks_fused(*problem[:3], cfg, alpha=problem[3])
                        torch.cuda.synchronize()
                    same = same and torch.equal(got, again)
                    errs[n] = float((got - ref).abs().max()) / float(ref.abs().max())
                ok = same and errs[args.n_iter] < limit
                failed = failed or not ok
                emit(nB=nB, P=P, K=K, operands=mm, cluster_size=plan.cluster_size, rows=plan.rows, waves=plan.waves,
                     stages=plan.stages, rel_err_1_iteration=errs[1], rel_err=errs[args.n_iter], n_iter=args.n_iter,
                     limit=limit, equal_bits=same, ok=ok)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
