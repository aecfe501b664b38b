"""Start the ranks of one machine (counterpart of ``scripts/launch_distributed.py``).

    python -m lrs_pnp_dip_tpu_torch.parallel.launch --nproc 2 [--device cpu|cuda]

runs :func:`.distributed.multiprocess_dryrun` on ``--nproc`` ranks over
gloo and exits non-zero when a rank fails.  :func:`spawn` runs any function
of the package the same way and returns what each rank returned.

The ranks are processes of ``torch.multiprocessing`` with the ``spawn``
start method (CUDA cannot fork).  They rendezvous through a file store in a
fresh temporary directory unless the caller gives an ``init_method``, so
concurrent launches do not meet, and each runs with one intra-op thread.
On the card every rank shares device ``rank % n_cards``.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def _rank_main(rank, nproc, fn, args, device, init_method, out_dir, timeout_s):
    from ..utils.device import resolve_device
    from .distributed import initialize

    torch.set_num_threads(1)
    if device == "cuda":
        resolve_device(device)  # TF32 off in this process too
    initialize(init_method=init_method, world_size=nproc, rank=rank, timeout_s=timeout_s)
    try:
        result = fn(*args)
        tmp = os.path.join(out_dir, f"rank_{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(out_dir, f"rank_{rank}.pkl"))
    finally:
        dist.destroy_process_group()


def spawn(
    fn: Callable,
    nproc: int,
    args: Sequence = (),
    device: str = "cpu",
    init_method: Optional[str] = None,
    timeout_s: float = 600.0,
) -> list:
    """Run ``fn(*args)`` on ``nproc`` ranks of a fresh gloo group and return
    each rank's result, in rank order.  ``fn`` must be importable by name
    (a function of a module, not of a test), and a script that calls this
    must do so under ``if __name__ == "__main__"``: each rank imports the
    caller's main module.  A failing rank raises here
    (``torch.multiprocessing.ProcessRaisedException``), and the others are
    stopped; so are all of them, with ``TimeoutError``, when they have not
    finished ``timeout_s`` seconds after the start (which is also how long a
    collective may wait)."""
    out_dir = tempfile.mkdtemp(prefix="lrs_ranks_")
    try:
        if init_method is None:
            init_method = "file://" + os.path.join(out_dir, "store")
        deadline = time.monotonic() + timeout_s
        ranks = torch.multiprocessing.start_processes(
            _rank_main,
            args=(nproc, fn, tuple(args), device, init_method, out_dir, timeout_s),
            nprocs=nproc, join=False, start_method="spawn",
        )
        while not ranks.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ranks.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"{nproc} ranks of {fn.__qualname__} did not finish in {timeout_s} s")
        results = []
        for rank in range(nproc):
            with open(os.path.join(out_dir, f"rank_{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def main(argv=None) -> int:
    from .distributed import multiprocess_dryrun

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    parser.add_argument("--timeout", type=float, default=600.0, help="seconds a collective may wait")
    a = parser.parse_args(argv)
    spawn(multiprocess_dryrun, a.nproc, args=(True, a.device), device=a.device, timeout_s=a.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
