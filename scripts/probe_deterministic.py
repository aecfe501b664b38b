#!/usr/bin/env python3
"""Check on the card that no DIP net's fit runs an operation without a
deterministic implementation.

    python scripts/probe_deterministic.py

Sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before torch initialises CUDA and
turns on ``torch.use_deterministic_algorithms(True)``, under which an
operation that has only a nondeterministic implementation on the card
raises.  Then runs, at 36x36x128: two iterations of the DIP fit (the first
eager, then a captured one replayed, chunk 1) of the `dip` preset's
skip-128 in f32 and in bf16, of the `dip_1lip` preset's Lipschitz U-Net, and
of every ``get_net`` key that keeps the iterate's shape (skip, ResNet,
lipschitz_unet, identity); and one step of ``solvers.fit`` with Adam of every
other key at the input shape it takes (UNet, texture_nets, deep_decoder,
res_decoder, UNet3D).  Prints one JSON line and exits 0 when every one ran,
1 when one raised.  It only checks: the port itself never sets this mode.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # before CUDA is initialised

SOLVE_KEYS = ("skip", "ResNet", "lipschitz_unet", "identity")
FIT_INPUTS = {  # the other keys, at the input shapes they take
    "UNet": (1, 32, 32, 128), "texture_nets": (1, 36, 36, 128), "deep_decoder": (1, 4, 4, 128),
    "res_decoder": (1, 4, 4, 128), "UNet3D": (1, 32, 32, 32, 1),
}


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    if not torch.cuda.is_available():
        print("probe_deterministic: no CUDA device is available", file=sys.stderr)
        return 1
    from lrs_pnp_dip_tpu_torch.data import synthetic_sample
    from lrs_pnp_dip_tpu_torch.models import get_net
    from lrs_pnp_dip_tpu_torch.solvers import DipFit, FitConfig, fit
    from lrs_pnp_dip_tpu_torch.solvers.admm import default_net
    from lrs_pnp_dip_tpu_torch.utils import resolve_device
    from lrs_pnp_dip_tpu_torch.utils.config import PRESETS

    resolve_device("cuda")
    torch.use_deterministic_algorithms(True)
    sample = synthetic_sample(36, 36, 128, seed=0)
    Z = torch.from_numpy(sample.noisy).cuda()[None]
    mask = torch.from_numpy(sample.mask).cuda()[None, :, :, None].expand_as(Z).contiguous()
    nets = [
        ("dip skip-128 f32", "dip", None, "float32"), ("dip skip-128 bf16", "dip", None, "bfloat16"),
        ("dip_1lip Lipschitz U-Net", "dip_1lip", None, "float32"),
    ] + [(f"get_net {k}", "dip", k, "float32") for k in SOLVE_KEYS]
    ran, failed = [], {}
    for label, variant, key, dtype in nets:
        cfg = PRESETS[variant]() if key is None else PRESETS[variant](dip_net=key)
        net = default_net(cfg, 128).cuda()
        dip_cfg = dataclasses.replace(cfg.dip, num_iter=2, patience=10**9, compute_dtype=dtype)
        try:
            DipFit(net, dip_cfg)(Z, Z, mask, generator=torch.Generator(device="cuda").manual_seed(0), chunk=1)
            torch.cuda.synchronize()
            ran.append(label)
        except RuntimeError as e:
            failed[label] = str(e)[:300]
    for key, shape in FIT_INPUTS.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        net = get_net(shape[-1], key, pad="reflection", n_channels=shape[-1])
        x = torch.rand(shape, device="cuda", generator=g)
        try:
            out = fit(net, g, x, torch.zeros_like(net.cuda()(x)), config=FitConfig(num_iter=1, lr=0.01))
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out.losses).all()):
                raise RuntimeError("non-finite loss")
            ran.append(f"fit {key}")
        except RuntimeError as e:
            failed[f"fit {key}"] = str(e)[:300]
    print(json.dumps({"deterministic_algorithms": True, "ran": ran, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
