#!/usr/bin/env python3
"""Where one outer step of a preset of the port spends its time, on the card.

    python scripts/profile_port_step.py [--variant dip] [--dip-net KEY] \\
        [--dip-iters 100] [--trace-iters 40] [--trace-out FILE]

``--variant`` is any preset (`dip`, `dip_1lip`, `dip_fast`, `lrs_pnp`,
`matlab`, ...); ``--dip-net`` a ``get_net`` key that replaces the preset's
net.  At the reference size (synthetic_sample(36, 36, 128, seed=0), the
shipped dictionary, 144 blocks), after one warm-up step, it prints:

  * the wall time of one outer step with the DIP fit capped at
    ``--dip-iters`` iterations (the early stop may end it sooner), the fit
    replayed from its captured iteration as ``Solver.run`` runs it;
  * the sparse prox's time (CUDA events) and, for `lrs_pnp`, the SVT's;
  * for a DIP preset, the host-stepped fit's time per iteration and a
    torch.profiler table of ``--trace-iters`` of its iterations (their
    kernels; ``chip_smoke.py`` phase 9 profiles the replayed iteration
    beside it); for `lrs_pnp` and `matlab`,
    the same table of one outer step: device time and host time by operator, the
    device's busy share of the wall time;

and, with ``--trace-out``, writes the Chrome trace there.  It needs a CUDA
device and fails without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from lrs_pnp_dip_tpu_torch.data import load_trained_dictionary, synthetic_sample  # noqa: E402
from lrs_pnp_dip_tpu_torch.ops import block_grid, extract_blocks, sparse_prox, svt_gram  # noqa: E402
from lrs_pnp_dip_tpu_torch.solvers import Solver, make_dip_fit  # noqa: E402
from lrs_pnp_dip_tpu_torch.solvers.admm import default_net  # noqa: E402
from lrs_pnp_dip_tpu_torch.utils import PRESETS, resolve_device  # noqa: E402


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="dip", choices=sorted(PRESETS))
    ap.add_argument("--dip-net", default="default", help="a get_net key for the DIP fit")
    ap.add_argument("--dip-iters", type=int, default=100)
    ap.add_argument("--trace-iters", type=int, default=40)
    ap.add_argument("--trace-out", default=None, help="Chrome trace file to write")
    args = ap.parse_args()
    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}; variant {args.variant}, dip_net {args.dip_net}")

    sample = synthetic_sample(36, 36, 128, seed=0)
    D = load_trained_dictionary(512)
    cfg = PRESETS[args.variant](dip_net=args.dip_net)
    if cfg.dip is not None:
        cfg = dataclasses.replace(cfg, dip=dataclasses.replace(cfg.dip, num_iter=args.dip_iters))
    solver = Solver(sample, D, cfg, device=device)
    state, _ = solver.step(solver.init_state())  # warm-up: cuDNN set-up, kernel build
    t0 = time.perf_counter()
    state, aux = solver.step(state)
    float(aux.mpsnr)
    step_s = time.perf_counter() - t0
    print(f"outer step: {step_s * 1e3:.1f} ms wall, dip_iters {aux.dip_iters}")

    c = solver.consts
    grid = block_grid((36 * 36, 128), cfg.block_size, cfg.stride)
    blocks = extract_blocks(state.X + state.lambda1 / cfg.mu1, grid)
    prox_ms = cuda_ms(lambda: sparse_prox(blocks, c.mask_blocks, c.D, cfg.sparse, alpha=c.alpha))
    print(f"sparse prox ({cfg.sparse.denoiser}: B1 for nlm_fast, else the plain loop; with the "
          f"reconstruction, {cfg.sparse.matmul_dtype} operands, {cfg.sparse.n_iter} iterations): "
          f"{prox_ms:.3f} ms")

    if cfg.dip is None:
        z = state.X + state.lambda2 / cfg.mu2
        print(f"SVT (svt_gram of the (1296, 128) iterate): {cuda_ms(lambda: svt_gram(z, 1 / cfg.mu2)):.3f} ms")
        unit, n_units = "outer step", 1

        def profiled():
            float(solver.step(state)[1].mpsnr)
    else:
        net = default_net(cfg, 128).to(device)
        fit_cfg = dataclasses.replace(cfg.dip, num_iter=args.trace_iters, patience=10**9)
        fit = make_dip_fit(net, fit_cfg)
        z = (state.X + state.lambda2 / cfg.mu2).reshape(1, 36, 36, 128)
        gen = torch.Generator(device=device).manual_seed(0)
        unit, n_units = "DIP iteration", args.trace_iters

        def profiled():
            fit(z, c.dip_target, c.dip_mask, generator=gen)

        profiled()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        profiled()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        print(f"DIP fit ({type(net).__name__}, {cfg.dip.compute_dtype}): "
              f"{fit_s / args.trace_iters * 1e3:.3f} ms per iteration "
              f"({args.trace_iters} iterations, no profiler)")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        profiled()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device busy time: the union of the kernels' intervals (user annotations,
    # such as the optimizer's range, also carry device times and are left out)
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    print(f"profiled: wall {wall_us / 1e3:.1f} ms, {len(kernels) / n_units:.0f} "
          f"kernels per {unit}, device busy {busy_us / 1e3:.1f} ms "
          f"({busy_us / wall_us:.1%}), idle {1 - busy_us / wall_us:.1%}")
    events = prof.key_averages()
    for key in ("self_device_time_total", "self_cpu_time_total"):
        print(f"--- top operators by {key}")
        print(events.table(sort_by=key, row_limit=18, max_name_column_width=60))
    if args.trace_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace_out)), exist_ok=True)
        prof.export_chrome_trace(args.trace_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
