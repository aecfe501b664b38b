"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU when no card is present."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "lrs_pnp_dip_tpu_torch"

_PROBE = """
import sys
before = set(sys.modules)
import lrs_pnp_dip_tpu_torch
from lrs_pnp_dip_tpu_torch import api, data, models, ops, solvers, utils
from lrs_pnp_dip_tpu_torch.ops import ista_cuda, svt
from lrs_pnp_dip_tpu_torch.solvers import batch, tiled
from lrs_pnp_dip_tpu_torch.data import tiles
from lrs_pnp_dip_tpu_torch.models import lipschitz, lipschitz_unet
from lrs_pnp_dip_tpu_torch.models import attention, deep_decoder, downsampler, resnet, texture_nets, unet, unet3d
from lrs_pnp_dip_tpu_torch.ops import bm3d, nlm, proxlib, ssim
from lrs_pnp_dip_tpu_torch import native
from lrs_pnp_dip_tpu_torch.data import dictionary, io
from lrs_pnp_dip_tpu_torch.utils import checkpoint, logging, noise, profiling, viz
import lrs_pnp_dip_tpu_torch.solvers.fit
from lrs_pnp_dip_tpu_torch import parallel
from lrs_pnp_dip_tpu_torch.parallel import collectives, distributed, engine, launch, mesh, sharding, tensor, workers
from lrs_pnp_dip_tpu_torch.utils import comm
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "lrs_pnp_dip_tpu"))
assert not bad, bad
assert "lrs_pnp_dip_tpu" not in sys.modules
from lrs_pnp_dip_tpu_torch.data import synthetic_sample
s = synthetic_sample(12, 12, 16, seed=0)
try:
    lrs_pnp_dip_tpu_torch.inpaint(s.noisy, s.mask, n_iters=1, block_size=6, stride=6,
                                  dictionary=s.noisy[:6, :6].reshape(36, 16))
except RuntimeError as e:
    assert "no CUDA device" in str(e), e
    print("REFUSED")
# the new entry points refuse the CPU by default too: learning a dictionary
# (also inpaint's, without dictionary=), the generic fit, get_dip_out
from lrs_pnp_dip_tpu_torch.data import learn_dictionary
from lrs_pnp_dip_tpu_torch.models import Identity
from lrs_pnp_dip_tpu_torch.solvers import FitConfig, fit, get_dip_out
from lrs_pnp_dip_tpu_torch.ops.proxlib import superresolution_operator
import numpy as np
calls = [
    lambda: learn_dictionary(np.ones((4, 8), np.float32), n_atoms=2, n_outer=1),
    lambda: lrs_pnp_dip_tpu_torch.inpaint(s.noisy, s.mask, n_iters=1, block_size=6, stride=6),
    lambda: fit(Identity(), None, s.noisy[None], s.noisy[None], config=FitConfig(num_iter=1)),
    lambda: get_dip_out(Identity(), None, s.noisy[None], s.noisy[None], s.mask[None, :, :, None], num_iter=1),
    lambda: superresolution_operator((4, 4), 2),
]
for call in calls:
    try:
        call()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
        print("REFUSED")
    else:
        raise AssertionError("ran on the CPU without being asked")
"""


def test_port_imports_no_jax_and_refuses_cpu_fallback():
    assert not torch.cuda.is_available()
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["REFUSED"] * 6


def test_port_sources_name_no_jax_module():
    """No import statement in the package names JAX, flax, optax or the
    JAX package (a static check: it also covers imports inside functions)."""
    banned = ("jax", "jaxlib", "flax", "optax", "lrs_pnp_dip_tpu")
    for path in PORT.rglob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"
