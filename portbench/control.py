#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card.

    python portbench/control.py --workload <name> --seeds 11 12 13 ... \\
        [--control-seeds 11 12 13] [--seconds 4] [--fault NAME] [--out FILE]

For each seed it makes the cell's inputs, sets the program up and runs a
short window of the cell's own traffic, exactly as a run of ``run.py``
does; then it prints, as one JSON line per seed:

  * ``program``: the compared numbers of the program's answers (the lower
    readings: the largest over a dozen seeds or more; with ``--fault``, the
    program with that fault of ``faults.py`` planted, which sets an upper
    reading where the control sets none);
  * ``control``: for the seeds of ``--control-seeds``, the same numbers of
    the control, the reference in a lower precision put in the program's
    place (TF32; for a bf16 configuration, fp8 operands: the driver's
    ``readings(control=True)``), the upper readings: the smallest over three
    seeds or more;
  * with ``--vary-problem`` a cell whose problem is fixed (``problem_seed``)
    takes each seed as its problem's, so the readings span a dozen problems.

The benchmark's runs never run this.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--fault", default=None, help="a fault of faults.py to plant in the program")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cell", default="{}", help="JSON: keys of the cell file to change, e.g. checked_steps")
    ap.add_argument("--vary-problem", action="store_true",
                    help="cells with a fixed problem_seed: take each seed as the problem's seed")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 3
    if args.fault:
        from faults import FAULTS

        FAULTS[args.fault](setattr)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = json.loads(args.cell)
        if args.vary_problem:
            cell["problem_seed"] = seed
        _, ctx, driver = run.build(args.workload, seed, "cuda", {"cell": cell})
        driver.setup()
        records, failed, window_s = run.window(driver, args.seconds)
        driver.release()
        gc.collect()
        line = {"workload": args.workload, "seed": seed, "fault": args.fault, "requests": len(records),
                "failed": failed, "window_s": window_s,
                "dip_iters": [n for r in records for n in r.info.get("dip_iters", ())],
                "program": driver.readings()}
        line["steps"] = getattr(driver, "rows", None)
        if seed in args.control_seeds:
            line["control"] = driver.readings(control=True)
            line["control_steps"] = getattr(driver, "rows", None)
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        del driver, ctx
        gc.collect()
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
