"""What every traffic driver shares: the run's context, the record of one
request, and the comparison with the reference."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from reference import solver as ref
from yardstick import inputs


@dataclasses.dataclass
class Context:
    """One run of one cell: the files that name it and what set-up made."""

    workload: str
    seed: int
    device: torch.device
    config: dict  # portbench/configs/<config>.json
    cell: dict  # portbench/cells/<workload>.json
    cfg: object  # the port's SolverConfig, from config["solver"]
    setup: ref.Setup  # the reference's numbers, from config["solver"]
    problem: dict  # config["problem"], with the cell's own sizes over it
    dictionary: Optional[np.ndarray] = None


class Record(NamedTuple):
    """One request of the window."""

    t0: float  # host clock at the call
    t1: float  # host clock when the answer is on the host
    tiles: int  # 36x36xB tiles returned (a cube is one tile)
    steps: int  # outer steps run
    info: dict  # what the request's own result says (per-step seconds, DIP iterations)


def now() -> float:
    return time.perf_counter()


@contextlib.contextmanager
def reference_precision(device: torch.device, tf32: bool):
    """The reference's products in float32 (``tf32=False``) or in TF32, the
    control's precision; cuDNN's deterministic algorithms either way.  The
    flags are put back after."""
    cuda_mm = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    saved = (cuda_mm.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    cuda_mm.allow_tf32 = cudnn.allow_tf32 = tf32
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cuda_mm.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved


def gap(answer, reference) -> float:
    """max |answer - reference| / max |reference|: the largest error of any
    entry, against the answer's scale.  Non-finite answers read inf."""
    a = torch.as_tensor(answer, dtype=torch.float64)
    r = torch.as_tensor(reference, dtype=torch.float64).to(a.device)
    if a.shape != r.shape or not torch.isfinite(a).all():
        return float("inf")
    return float((a - r).abs().max() / r.abs().max())


def pool(ctx: Context, n: int, height: int, width: int) -> list:
    """``n`` problems (noisy, mask, clean) of ``height`` x ``width`` from the seed."""
    p = ctx.problem
    return inputs.problem_pool(ctx.seed, n, height, width, p["bands"], p["rank"], p["missing"],
                               p["noise_sigma"])


class Reservoir:
    """A uniform sample of at most ``size`` of the items offered, drawn from
    ``seed`` (reservoir sampling): the answers the check compares, whatever
    the number of requests the window holds."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.items = []
        self.seen = 0
        self.rng = np.random.default_rng(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.size:
                self.items[j] = item


def blocks_per_cube(ctx: Context, height: int, width: int) -> int:
    """The blocks of one height x width cube: B1's rows for it."""
    s = ctx.setup
    P = height * width
    return len(ref.grid(P, ctx.problem["bands"], s.block_size, s.stride).band_starts) * (P // s.block_size)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
