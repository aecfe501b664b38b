#!/usr/bin/env python3
"""The readings behind the limits of the 1-Lip cell, on the card:
``portbench/control.py`` with one more fault to plant, ``sn_omitted``.

    python scripts/readings_1lip.py --workload dip_1lip.cube36 --seeds 11 12 13 \\
        [--control-seeds 11 12 13] [--vary-problem] [--fault sn_omitted] [--out FILE]

Takes ``control.py``'s arguments.  ``sn_omitted`` leaves the spectral norm
out of the program: sigma's factor held at 1 in every ``SNConv2d`` (the
power iteration still runs and advances u), which sets the upper reading of
``net_gap`` beside the TF32 control.  It needs a CUDA card.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "portbench"))

import control  # noqa: E402
import torch  # noqa: E402
import faults  # noqa: E402
from lrs_pnp_dip_tpu_torch.models import lipschitz  # noqa: E402


def sn_omitted(patch) -> None:
    """The spectral norm left out: sigma's factor held at 1 in every
    ``SNConv2d`` (the power iteration still runs and advances u)."""
    norms = lipschitz.spectral_norms

    def unit(weights, us, ln_lambdas, n_iters):
        table = norms(weights, us, ln_lambdas, n_iters)
        return torch.stack([table[0] * 0.0, torch.ones_like(table[1])])

    patch(lipschitz, "spectral_norms", unit)


faults.FAULTS["sn_omitted"] = sn_omitted

if __name__ == "__main__":
    sys.exit(control.main())
