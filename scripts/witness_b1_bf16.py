#!/usr/bin/env python3
"""Where a bf16 tiling of kernel B1 leaves the bf16 plain loop, and whether
the plain loop itself leaves itself as far when only the order of its sums
changes.  Runs on the card.

    python scripts/witness_b1_bf16.py [--nB 72] [--P 1296] [--K 512] [--n-iter 12]
                                      [--seeds 1808 0 1] [--perms 32]

The problem is that of ``tests/test_torch_cuda.py:_problem`` (random blocks,
12% of the values missing, the second block wholly missing, a random
unit-column dictionary; seed ``P + K`` = 1808 is the card test's) with the
trace4 alpha.  For each seed and each tiling of ``plan_candidates`` (forced
through ``ISTA_KERNEL.forcing``) one JSON line gives:

- ``max_abs_err`` and ``rel`` (over max|ref|) against the bf16 plain loop
  after ``--n-iter`` iterations, the row it is in, and the five largest
  per-row errors (block rows are independent problems, so one flipped
  rounding moves one row);
- ``by_iteration``: max |delta| and its row after 1, 2, ... ``--n-iter``
  iterations, which shows the iteration a row departs at;
- against the plain loop with the rows of D (and the columns of Y and M)
  permuted ``--perms`` ways: each permutation's max |delta| from the
  unpermuted loop (``perm_errs``), how many reach the kernel's, and
  ``same_row_gap``, the least max |delta| between the kernel's worst row and
  that row of a permuted loop: far below the kernel's error when a
  permutation flips the same rounding the kernel does;
- the two floors of the card test (``_order_sensitivity``'s first two
  permutations, ``_tensor_core_sensitivity``) and its limit,
  max(1e-5 max|ref|, 4 x the larger floor).

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def problem(nB: int, P: int, K: int, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    D = rng.standard_normal((P, K)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    Y = rng.standard_normal((nB, P)).astype(np.float32)
    M = (rng.random((nB, P)) > 0.12).astype(np.float32)
    M[min(1, nB - 1)] = 0.0
    return [torch.from_numpy(a).cuda() for a in (Y, M, D)]


def permuted(Y, M, D, seed: int):
    import torch

    perm = torch.randperm(D.shape[0], generator=torch.Generator().manual_seed(seed)).to(D.device)
    return Y[:, perm].contiguous(), M[:, perm].contiguous(), D[perm].contiguous()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nB", type=int, default=72)
    ap.add_argument("--P", type=int, default=1296)
    ap.add_argument("--K", type=int, default=512)
    ap.add_argument("--n-iter", type=int, default=12)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1808, 0, 1])
    ap.add_argument("--perms", type=int, default=32)
    args = ap.parse_args()

    import torch

    from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, compute_alpha, pnp_ista_blocks, pnp_ista_blocks_fused
    from lrs_pnp_dip_tpu_torch.ops.ista_cuda import _MAX_SMEM_BYTES, plan_candidates
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    nB, P, K, n = args.nB, args.P, args.K, args.n_iter
    plans = plan_candidates(nB, P, K, True, ISTA_KERNEL.resident_clusters(True), _MAX_SMEM_BYTES)
    pick = ISTA_KERNEL.plan(nB, P, K, True)
    for seed in args.seeds:
        Y, M, D = problem(nB, P, K, seed)
        cfg = SparseProxConfig(n_iter=n, matmul_dtype="bfloat16")
        alpha = compute_alpha(D, M, cfg)
        ref = pnp_ista_blocks(Y, M, D, cfg, alpha=alpha)
        scale = float(ref.abs().max())
        perm_outs = [pnp_ista_blocks(*permuted(Y, M, D, s), cfg, alpha=alpha) for s in range(args.perms)]
        perm_errs = [float((o - ref).abs().max()) for o in perm_outs]
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        tensor_core = float((pnp_ista_blocks(Y, M, D, cfg, alpha=alpha) - ref).abs().max())
        torch.backends.cuda.matmul.allow_tf32 = saved
        floor = max(max(perm_errs[:2]), tensor_core)
        limit = max(1e-5 * scale, 4.0 * floor)
        for plan in plans:
            with ISTA_KERNEL.forcing(plan):
                got = pnp_ista_blocks_fused(Y, M, D, cfg, alpha=alpha)
                by_iteration = []
                for i in range(1, n + 1):
                    step_cfg = SparseProxConfig(n_iter=i, matmul_dtype="bfloat16")
                    d = (pnp_ista_blocks_fused(Y, M, D, step_cfg, alpha=alpha)
                         - pnp_ista_blocks(Y, M, D, step_cfg, alpha=alpha)).abs()
                    by_iteration.append([float(d.max()), int(d.max(dim=1).values.argmax())])
            rows = (got - ref).abs().max(dim=1).values
            worst = int(rows.argmax())
            err = float(rows[worst])
            same_row_gap = min(float((got[worst] - o[worst]).abs().max()) for o in perm_outs)
            line = {
                "nB": nB, "P": P, "K": K, "n_iter": n, "seed": seed, "tier": plan.tier,
                "cluster_size": plan.cluster_size, "rows": plan.rows, "pick": plan == pick,
                "max_ref": scale, "max_abs_err": err, "rel": err / scale, "row": worst,
                "top_rows": [[int(r), float(rows[r])] for r in rows.argsort(descending=True)[:5]],
                "by_iteration": by_iteration, "perm_errs": perm_errs,
                "perms_reaching": sum(e >= err for e in perm_errs), "same_row_gap": same_row_gap,
                "order_floor": max(perm_errs[:2]), "tensor_core_floor": tensor_core, "limit": limit,
                "within_limit": err < limit, "card": smi,
            }
            print(json.dumps(line), flush=True)
            print(f"seed {seed} {plan.tier:8s}: max|delta| {err:.3e} ({err / scale:.3e} of max|ref|) in row "
                  f"{worst}; limit {limit:.3e}; {line['perms_reaching']}/{args.perms} permutations reach it "
                  f"(largest {max(perm_errs):.3e}); same-row gap {same_row_gap:.3e}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
