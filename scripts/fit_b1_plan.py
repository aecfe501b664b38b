#!/usr/bin/env python3
"""Fit kernel B1's predicted time (``ops/ista_cuda.py:_COST_US``) to the
tier sweeps of ``scripts/time_b1.py --tiers`` and check the plan's picks.

    python scripts/fit_b1_plan.py [SWEEP.jsonl ...]

Reads the sweep lines (by default ``scripts/b1_tier_sweeps.jsonl``, the
sweeps the constants in the code were fitted to), rebuilds each
candidate's ``IstaPlan`` and, per tier and operand type, fits the five
constants of one wave's iteration (a + b steps + c FMAs + d bytes + e
values of ``iteration_counts``, all at least 0) by least squares on the
relative error.  Prints the fitted table, each group's largest relative
error (``_FIT_ERROR``, the margin of a pick off ``SWEPT_SHAPES``), how far
the candidates' medians moved between two calls (its third quartile sets
``TIE_MARGIN``), and then, for the constants in the code,
every swept shape of every call whose pick (``pick_plan``) is more than 5%
slower than the fastest candidate of that call.  Runs on the CPU.
"""

from __future__ import annotations

import itertools
import json
import statistics
import sys
from pathlib import Path

import numpy as np
from scipy.optimize import nnls

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from lrs_pnp_dip_tpu_torch.ops import ista_cuda  # noqa: E402
from lrs_pnp_dip_tpu_torch.ops.ista_cuda import IstaPlan, iteration_counts, pick_plan  # noqa: E402

TIERS = ("resident", "streamed", "column")


def load(paths) -> list:
    """Each sweep line as (line, the candidate's IstaPlan)."""
    fields = set(IstaPlan.__dataclass_fields__)
    out = []
    for path in paths:
        for text in Path(path).read_text().splitlines():
            row = json.loads(text)
            plan = IstaPlan(bf16=row["operands"] == "bfloat16", **{k: v for k, v in row.items() if k in fields})
            out.append((row, plan))
    return out


def features(plan: IstaPlan) -> list:
    """The terms of ``predicted_ms`` in the units of ``_COST_US``."""
    steps, fmas, l2, exchanged = iteration_counts(plan)
    return [1.0, steps, fmas / 1e6, l2 / 1e6, exchanged / 1e3]


def wave_iteration_us(row: dict, plan: IstaPlan) -> float:
    return row["ms"] * 1e3 / (plan.waves * row["n_iter"])


def fit(rows) -> dict:
    """The constants of each (tier, bf16) group, and its largest relative error."""
    table = {}
    for tier in TIERS:
        for bf16 in (False, True):
            group = [(r, p) for r, p in rows if p.tier == tier and p.bf16 == bf16]
            if not group:
                continue
            A = np.array([features(p) for _, p in group])
            y = np.array([wave_iteration_us(r, p) for r, p in group])
            coef, _ = nnls(A / y[:, None], np.ones(len(y)))
            worst = float(np.abs(A @ coef / y - 1).max())
            table[tier, bf16] = (tuple(float(f"{c:.4g}") for c in coef), worst, len(group))
    return table


def misses(rows, limit: float = 1.05) -> list:
    """(call, shape, pick's ms, fastest ms) where the code's pick is more
    than ``limit`` times the fastest candidate timed in the same call."""
    shapes = {}
    for row, plan in rows:
        shapes.setdefault((row["label"], plan.nB, plan.P, plan.K, plan.bf16), []).append((row, plan))
    out = []
    for key, group in shapes.items():
        group.sort(key=lambda rp: TIERS.index(rp[1].tier))
        pick = pick_plan([p for _, p in group])
        ms = {p: r["ms"] for r, p in group}
        if ms[pick] > limit * min(ms.values()):
            out.append((key, pick.tier, ms[pick], min(ms.values())))
    return out


def main() -> int:
    paths = sys.argv[1:] or [HERE / "scripts" / "b1_tier_sweeps.jsonl"]
    rows = load(paths)
    table = fit(rows)
    print("_COST_US = {")
    for (tier, bf16), (coef, worst, n) in table.items():
        print(f"    ({tier!r}, {bf16}): {coef},  # {n} timings, largest relative error {worst:.3f}")
    print("}")
    by_call = {}
    for r, p in rows:
        by_call.setdefault((p.nB, p.P, p.K, p.bf16, p.tier), []).append(r["ms"])
    moved = [abs(a / b - 1) for ms in by_call.values() for a, b in itertools.combinations(ms, 2)]
    if len(moved) > 1:
        print(f"candidates' medians between two calls: moved by {statistics.median(moved):.4f} (median), "
              f"{statistics.quantiles(moved, n=4)[2]:.4f} (third quartile); TIE_MARGIN {ista_cuda.TIE_MARGIN}")
    found = misses(rows)
    for key, tier, got, best in found:
        print(f"miss: {key}: pick {tier} {got:.4f} ms, fastest {best:.4f} ms ({got / best - 1:+.1%})")
    n_shapes = len({(r["label"], p.nB, p.P, p.K, p.bf16) for r, p in rows})
    print(f"{n_shapes - len(found)} of {n_shapes} swept shapes picked within 5% of the fastest")
    return 0


if __name__ == "__main__":
    sys.exit(main())
