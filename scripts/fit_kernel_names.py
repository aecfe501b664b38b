#!/usr/bin/env python3
"""The kernels of a replayed DIP iteration on the card, by name.

    python scripts/fit_kernel_names.py [--workloads dip_1lip.cube36 dip.cube36] [--steps 1]
        [--out FILE]

For each benchmark cell named, it sets the cell up on one cube, traces
``--steps`` outer steps as the cell's traced stretch does, and counts the
device operations inside the ``dip.fit`` spans by name, per replayed
iteration (the graph launches inside them).  It prints, per cell, the
operations an iteration, how many of them ``sn_pct.step``'s name rule
(``portbench/metrics/sn_pct.step.py``) picks against twice the net's
``power_products``, and the names with their counts; the full table goes to
``--out``.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "portbench"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", nargs="+", default=["dip_1lip.cube36", "dip.cube36"])
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--seed", type=int, default=3180000001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import run
    from yardstick import spans
    from yardstick import trace as tr

    if not torch.cuda.is_available():
        print("fit_kernel_names.py needs a CUDA card", file=sys.stderr)
        return 3
    rule = run.load_metric("sn_pct.step").__globals__["is_sn_kernel"]
    table = {}
    for workload in args.workloads:
        _, ctx, driver = run.build(workload, args.seed, "cuda",
                                   {"cell": {"pool": 1, "trace_steps": args.steps}})
        driver.setup()
        traced = run._profile(driver, ctx.device, tr)
        fits = spans.named(traced, "dip.fit")
        iters = spans.calls_inside(traced, fits, "cudaGraphLaunch".__eq__)
        ops = spans.inside(traced.device, fits)
        by_name = collections.Counter(iv.name for iv in ops)
        ns = collections.Counter()
        for iv in ops:
            ns[iv.name] += iv.end_ns - iv.start_ns
        net = driver.solvers[0].stages.dip_fit.model
        products = getattr(net, "power_products", None)
        matched = [iv for iv in ops if rule(iv.name)]
        row = {
            "workload": workload, "fits": len(fits), "iterations": iters,
            "ops_per_iteration": len(ops) / iters, "power_products": products,
            "rule_matches_per_iteration": len(matched) / iters,
            "rule_share_pct": 100.0 * sum(iv.end_ns - iv.start_ns for iv in matched) / max(1, spans.total_ns(ops)),
            "fit_ms": spans.total_ns(fits) / 1e6,
            "names": sorted(([n, c / iters, ns[n] / 1e3 / iters, rule(n)] for n, c in by_name.items()),
                            key=lambda r: -r[1]),
        }
        table[workload] = row
        print(json.dumps({k: v for k, v in row.items() if k != "names"}), flush=True)
        for name, per_iter, us, hit in row["names"][:40]:
            print(f"  {per_iter:8.2f} {us:9.2f} us {'SN' if hit else '  '} {name[:150]}")
        driver.release()
        del driver, ctx
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(table, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
