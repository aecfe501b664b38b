#!/usr/bin/env python3
"""Probe what a CUDA graph can capture on the card the port runs on.

    python3 scripts/probe_graph_capture.py

Prints the torch / CUDA versions and the card's name and power limit; captures kernel B1 at the main shape
(nB 144, P 1296, K 512, f32 and bf16) and checks a replay against an eager
launch bit for bit; captures one skip-128 forward + backward + parameter
update and times it replayed against eager (ms per iteration over 50); and,
each in a fresh process because a failed capture can spoil the process's
CUDA context, tries to capture ``torch.linalg.eigh``, ``eigvalsh`` and
``torch._linalg_eigh`` of a 128x128 Gram matrix.  Needs one NVIDIA GPU.
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def capture(fn, label):
    """Two warm-up calls on a side stream, then a capture; (graph, out) or (None, None)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    except Exception as e:  # noqa: BLE001 - the probe reports any refusal
        print(f"{label}: capture FAILED: {type(e).__name__}: {str(e)[:300]}", flush=True)
        return None, None
    print(f"{label}: captured", flush=True)
    return graph, out


def probe_linalg(which: str) -> None:
    G = torch.randn(128, 128, device="cuda")
    G = G @ G.T
    fns = {
        "eigh": lambda: torch.linalg.eigh(G),
        "eigvalsh": lambda: torch.linalg.eigvalsh(G),
        "_linalg_eigh": lambda: torch._linalg_eigh(G, "L", True),
    }
    capture(fns[which], which)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_graph_capture: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) > 1:
        probe_linalg(sys.argv[1])
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print("torch", torch.__version__, "cuda", torch.version.cuda, "card", smi, flush=True)
    from lrs_pnp_dip_tpu_torch.data import load_trained_dictionary, synthetic_sample
    from lrs_pnp_dip_tpu_torch.models import dip_skip_128
    from lrs_pnp_dip_tpu_torch.ops import block_grid, extract_blocks, pnp_ista_blocks_fused
    from lrs_pnp_dip_tpu_torch.solvers import make_consts
    from lrs_pnp_dip_tpu_torch.utils import resolve_device
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig, dip_preset

    resolve_device("cuda")
    consts = make_consts(synthetic_sample(36, 36, 128, seed=0), load_trained_dictionary(512), dip_preset(),
                         device="cuda")
    blocks = extract_blocks(consts.Y, block_grid((1296, 128), 36, 36))
    for mm in ("float32", "bfloat16"):
        cfg = SparseProxConfig(n_iter=100, matmul_dtype=mm)

        def b1():
            return pnp_ista_blocks_fused(blocks, consts.mask_blocks, consts.D, cfg, alpha=consts.alpha)

        eager = b1()
        graph, out = capture(b1, f"B1 {mm}")
        if graph is not None:
            graph.replay()
            torch.cuda.synchronize()
            print(f"  replay equal bits: {torch.equal(out, eager)}", flush=True)

    net = dip_skip_128().cuda()
    x = torch.rand(1, 36, 36, 128, device="cuda")
    target = torch.rand(1, 36, 36, 128, device="cuda")
    params = list(net.parameters())
    print(f"skip-128: {len(params)} parameter tensors, {sum(p.numel() for p in params)} elements", flush=True)

    def iteration():
        loss = torch.mean((target - net(x)) ** 2)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            torch._foreach_add_(params, grads, alpha=-1e-3)
        return loss.detach()

    graph, _ = capture(iteration, "skip-128 forward + backward + update")
    if graph is not None:
        for label, fn in (("eager", iteration), ("graph", graph.replay)):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            print(f"  {label}: {(time.perf_counter() - t0) / 50 * 1e3:.3f} ms per iteration", flush=True)
    for which in ("eigh", "eigvalsh", "_linalg_eigh"):
        proc = subprocess.run([sys.executable, __file__, which], capture_output=True, text=True, timeout=120)
        print(proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else proc.stderr[-300:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
