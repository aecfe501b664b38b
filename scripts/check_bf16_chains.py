#!/usr/bin/env python3
"""Kernel B1's bf16 mma chains on the card: errors against the plain loop
beside its floors, and the times they cost.

    python scripts/check_bf16_chains.py [--reps 7]

- The resident bf16 kernel (``pnp_ista_cluster_bf16``) sums product 1 over
  all of K in one mma chain per tile: 40 k steps at K 640, its widest.  At
  nB 144 on main-path blocks (``chip_smoke.problem``) against a random
  1296x640 unit-column dictionary, at the `dip` sparse settings (100
  iterations, trace4 alpha, h_scale 1) and the `lrs_pnp` ones (80,
  specnorm, 0.1): max |delta| from the bf16 plain loop over max |ref|,
  beside the plain loop's two floors (rows of D permuted; its products on
  the tensor cores) and the limit of ``tests/test_torch_cuda.py``
  (``_assert_bf16_tracks``: the larger of 1e-5 and 4 times the floor).  The
  main shape (K 512) in bf16 is timed too.
- The column bf16 kernel (``pnp_ista_column_bf16``) cuts its mma chains
  every 8 steps of 16 and splits product 2 over two halves of the warps
  where a CTA has at most 16 column tiles of 16 and P has at least 32 steps
  of 16 rows (``split_taken``: seg / 16 <= 16 and ceil(P / 16) >= 32).  At
  P 256 / K 3000 and P 576 / K 2048 (``chip_smoke.wide_problem``, nB 144,
  100 iterations) it is timed and its errors measured the same way.

Prints one JSON line per row, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def floors(blocks, masks, D, alpha, cfg) -> dict:
    """The bf16 plain loop's own movement, over max |ref|: rows of D
    permuted (two seeds), and products on the tensor cores (TF32 takes the
    bf16-valued operands exactly and accumulates in f32, as mma.sync)."""
    import torch

    from lrs_pnp_dip_tpu_torch.ops import pnp_ista_blocks

    ref = pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha)
    scale = float(ref.abs().max())
    order = 0.0
    for seed in (0, 1):
        perm = torch.randperm(D.shape[0], generator=torch.Generator().manual_seed(seed)).to(D.device)
        moved = pnp_ista_blocks(blocks[:, perm], masks[:, perm], D[perm], cfg, alpha=alpha)
        order = max(order, float((moved - ref).abs().max()) / scale)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tc = float((pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha) - ref).abs().max()) / scale
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return dict(ref=ref, scale=scale, order_floor=order, tensor_core_floor=tc,
                limit=max(1e-5, 4.0 * max(order, tc)))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("check_bf16_chains: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from lrs_pnp_dip_tpu_torch.data import load_trained_dictionary
    from lrs_pnp_dip_tpu_torch.ops import ista
    from lrs_pnp_dip_tpu_torch.ops.ista import compute_alpha
    from lrs_pnp_dip_tpu_torch.utils import resolve_device
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    production = ista.ISTA_KERNEL
    production.build()

    def emit(**row):
        print(json.dumps(dict(row, card=smi)), flush=True)

    # the resident bf16 kernel at K 640
    D_np = load_trained_dictionary(512)
    blocks, masks, D512, alpha512 = chip_smoke.problem(36, 36, 0, D_np)
    rng = np.random.default_rng(640)
    D = rng.standard_normal((1296, 640)).astype(np.float32)
    D = torch.from_numpy(D / np.linalg.norm(D, axis=0, keepdims=True)).cuda()
    for settings, sparse in (("dip", dict(n_iter=100, alpha_mode="trace4", h_scale=1.0)),
                             ("lrs_pnp", dict(n_iter=80, alpha_mode="specnorm", h_scale=0.1))):
        cfg = SparseProxConfig(matmul_dtype="bfloat16", **sparse)
        alpha = compute_alpha(D, masks, cfg)
        got = ista.pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha)
        plan = production.last_plan
        f = floors(blocks, masks, D, alpha, cfg)
        err = float((got - f["ref"]).abs().max()) / f["scale"]
        emit(kernel="resident bf16", settings=settings, nB=144, P=1296, K=640, tier=plan.tier,
             k_steps_per_chain=plan.K // 16, max_rel_err=err, max_abs_ref=f["scale"],
             order_floor=f["order_floor"], tensor_core_floor=f["tensor_core_floor"], limit=f["limit"],
             passes=err < f["limit"])
    cfg = SparseProxConfig(n_iter=100, matmul_dtype="bfloat16")
    ms = chip_smoke.time_cuda(lambda: ista.pnp_ista_blocks_fused(blocks, masks, D512, cfg, alpha=alpha512),
                              reps=args.reps)
    emit(kernel="resident bf16", settings="dip", nB=144, P=1296, K=512, ms=ms)

    # the column bf16 kernel
    for block, K in ((16, 3000), (24, 2048)):
        blocks, masks, D, alpha = chip_smoke.wide_problem(block, K)
        f = floors(blocks, masks, D, alpha, cfg)
        got = ista.pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha)
        plan = production.last_plan
        ms = chip_smoke.time_cuda(lambda: ista.pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha),
                                  reps=args.reps)
        err = float((got - f["ref"]).abs().max()) / f["scale"]
        taken = plan.seg // 16 <= 16 and -(-plan.P // 16) >= 32
        emit(kernel="column bf16", nB=144, P=plan.P, K=K, tier=plan.tier, seg=plan.seg,
             split_taken=taken, ms=ms, max_rel_err=err, max_abs_ref=f["scale"], order_floor=f["order_floor"],
             tensor_core_floor=f["tensor_core_floor"], limit=f["limit"], passes=err < f["limit"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
