"""The system under test: the port, ``lrs_pnp_dip_tpu_torch``, and what the
benchmark takes from it (its entry points and its config types).  Nothing
else of the benchmark imports the port."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import lrs_pnp_dip_tpu_torch as port  # noqa: E402
from lrs_pnp_dip_tpu_torch.data.io import HsiSample  # noqa: E402
from lrs_pnp_dip_tpu_torch.solvers import Solver  # noqa: E402
from lrs_pnp_dip_tpu_torch.utils.config import (  # noqa: E402
    PRESETS, DipConfig, SolverConfig, SparseProxConfig)

inpaint = port.inpaint
inpaint_scene = port.inpaint_scene

__all__ = ["HsiSample", "Solver", "inpaint", "inpaint_scene", "preset", "solver_config"]


def solver_config(solver: dict) -> SolverConfig:
    """The port's config from a configuration file's ``solver`` object.
    Every field is the file's; a field the file lacks or the port does not
    know raises."""
    fields = dict(solver)
    fields["sparse"] = SparseProxConfig(**fields["sparse"])
    fields["dip"] = None if fields["dip"] is None else DipConfig(**fields["dip"])
    cfg = SolverConfig(**fields)
    if dataclasses.asdict(cfg) != solver:
        raise ValueError("the configuration file and the port's SolverConfig differ")
    return cfg


def preset(name: str, **overrides) -> SolverConfig:
    return PRESETS[name](**overrides)
