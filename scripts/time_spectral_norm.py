#!/usr/bin/env python3
"""Time the spectral norm kernel (``csrc/spectral_norm.cu``) against the
plain power iteration on the card, at the `dip_1lip` preset's 14 weights.

    python scripts/time_spectral_norm.py [--reps 7] [--calls 20] [--out FILE]

Both sides do a forward's work: the kernel one launch for the 14 weights;
the plain version ``models/lipschitz.py:_sigma_max_power`` conv by conv, the
factor's clamp and the copy of u, as the port ran before the kernel.  Each
is captured in a CUDA graph of ``--calls`` forwards, as the DIP fit replays
them, and timed with CUDA events over a replay after 2 warm-ups: the median
of ``--reps`` replays, in turns, divided by ``--calls``.  The kernel's eager
launch is timed the same way (host launch included).  Before timing, sigma
and u of one forward of each are compared (kernel against plain, relative
and max |delta|).  Prints one JSON line with the card's name and power
limit, the times in us, the bound (the weights read once from device memory
at 3.35 TB/s) and the errors; ``--out`` appends it to a file too.
``chip_smoke.py`` calls :func:`measure`.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lrs_pnp_dip_tpu_torch.models.lipschitz import _sigma_max_power  # noqa: E402
from lrs_pnp_dip_tpu_torch.ops.spectral_norm_cuda import SN_KERNEL  # noqa: E402

# (m, n) of the preset's convs: 128 bands, width 128
PRESET = [(128, 1152)] * 8 + [(128, 512)] * 2 + [(128, 1152)] * 2 + [(128, 128)] * 2
HBM_BYTES_PER_S = 3.35e12


def _card() -> dict:
    query = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": query.stdout.strip()}


def _inputs(seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    weights = [((torch.rand((m, n), generator=gen) * 2 - 1) * (6.0 / n) ** 0.5).cuda() for m, n in PRESET]
    us = [torch.randn(m, generator=gen).cuda() for m, _ in PRESET]
    return weights, us


def kernel_forward(weights, us):
    return SN_KERNEL.launch(weights, us, [1.0] * len(weights), [8] * len(weights))


def plain_forward(weights, us):
    factors = []
    for w, u in zip(weights, us):
        sigma, new_u = _sigma_max_power(w, u, 8)
        u.copy_(new_u)
        factors.append(torch.clamp(sigma / 1.0, min=1.0))
    return factors


def _graph_of(fn, calls: int):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def _event_ms(run) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def measure(reps: int = 7, calls: int = 20) -> dict:
    """The comparison and the times the module docstring describes, as a dict
    (the JSON line)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    weights, us = _inputs()
    k_us, p_us = [u.clone() for u in us], [u.clone() for u in us]
    table = kernel_forward(weights, k_us)
    plain = [_sigma_max_power(w, u, 8) for w, u in zip(weights, p_us)]
    torch.cuda.synchronize()
    sigma_rel = max(abs(float(table[0, g]) - float(s)) / float(s) for g, (s, _) in enumerate(plain))
    u_err = max(float((a - b).abs().max()) for a, (_, b) in zip(k_us, plain))

    graphs = {
        "kernel": _graph_of(lambda: kernel_forward(weights, k_us), calls),
        "plain": _graph_of(lambda: plain_forward(weights, p_us), calls),
    }
    eager = lambda: [kernel_forward(weights, k_us) for _ in range(calls)]  # noqa: E731
    runs = {"kernel": graphs["kernel"].replay, "plain": graphs["plain"].replay, "kernel_eager": eager}
    times = {name: [] for name in runs}
    for name, run in runs.items():
        for _ in range(2):
            _event_ms(run)
    for _ in range(reps):  # in turns
        for name, run in runs.items():
            times[name].append(_event_ms(run) * 1000.0 / calls)
    weight_bytes = 4 * sum(m * n for m, n in PRESET)
    return {
        "what": "spectral_norm", "shapes": "dip_1lip preset, 14 weights, 8 power steps", **_card(),
        "calls_per_replay": calls, "reps": reps,
        **{f"{name}_us": statistics.median(t) for name, t in times.items()},
        **{f"{name}_us_all": t for name, t in times.items()},
        "bound_us": weight_bytes / HBM_BYTES_PER_S * 1e6, "weight_bytes": weight_bytes,
        "plan": {"cluster_size": SN_KERNEL.last_plan.cluster_size, "smem_bytes": SN_KERNEL.last_plan.smem_bytes},
        "sigma_max_rel_err": sigma_rel, "u_max_abs_err": u_err,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=7)
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    line = measure(args.reps, args.calls)
    text = json.dumps(line)
    print(text)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
