#!/usr/bin/env python3
"""Which shapes kernel B1's plan meets on the card, and whether each pick
that leaves the first tier was timed by the sweeps.

    python scripts/log_b1_plans.py OUT.jsonl pytest [PYTEST ARGS ...]
    python scripts/log_b1_plans.py OUT.jsonl run SCRIPT.py [ARGS ...]

Wraps ``ista_cuda.plan_ista`` (which ``FusedIstaKernel.plan`` calls once
per shape) so that it appends each (nB, P, K, bf16) it plans to
``OUT.jsonl``, then runs pytest or a script in this process (for example
``pytest --noconftest -m cuda tests/test_torch_cuda.py`` or ``run
chip_smoke.py``); subprocesses are not followed.  Then prints, for every
shape planned, whether the pick leaves the first tier of
``plan_candidates`` and whether ``SWEPT_SHAPES`` holds the shape, and a
count of the moved shapes that no sweep timed.  Exits with the command's
own code.
"""

from __future__ import annotations

import json
import runpy
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def main() -> int:
    if len(sys.argv) < 3 or sys.argv[2] not in ("pytest", "run"):
        print(__doc__, file=sys.stderr)
        return 2
    from lrs_pnp_dip_tpu_torch.ops import ista_cuda

    out = Path(sys.argv[1])
    planned = []
    plan_ista = ista_cuda.plan_ista

    def logged(nB, P, K, bf16, *args, **kwargs):
        planned.append((nB, P, K, bool(bf16)))
        return plan_ista(nB, P, K, bf16, *args, **kwargs)

    ista_cuda.plan_ista = logged
    if sys.argv[2] == "pytest":
        import pytest

        rc = pytest.main(sys.argv[3:])
    else:
        sys.argv = sys.argv[3:]
        try:
            runpy.run_path(sys.argv[0], run_name="__main__")
            rc = 0
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
    ista_cuda.plan_ista = plan_ista
    untimed = 0
    with out.open("a") as f:
        for shape in sorted(set(planned)):
            try:
                pick = plan_ista(*shape)
                plans = ista_cuda.plan_candidates(*shape)
            except ValueError:
                continue
            moved = pick.tier != plans[0].tier
            swept = shape in ista_cuda.SWEPT_SHAPES
            untimed += moved and not swept
            f.write(json.dumps({"nB": shape[0], "P": shape[1], "K": shape[2], "bf16": shape[3],
                                "tiers": [p.tier for p in plans], "pick": pick.tier, "moved": moved,
                                "swept": swept}) + "\n")
    print(f"log_b1_plans: {len(set(planned))} shapes planned, {untimed} moved off the first tier untimed "
          f"({out})", file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
