"""lrs_pnp_dip_tpu_torch — the PyTorch / CUDA port of lrs_pnp_dip_tpu.

LRS-PnP-DIP hyperspectral inpainting: patch-wise dictionary sparse coding
by plug-and-play ISTA with an NLM denoiser, a Deep Image Prior low-rank
prox, and a mask-aware closed-form data-fidelity update inside an
ADMM-style outer loop.  The JAX package ``lrs_pnp_dip_tpu`` is the
reference; this package imports nothing of it and nothing of JAX.

Layout mirrors the JAX package:
  data/      canonical HSI layout, .mat loaders, masks, dictionary learning
             and the shipped dictionary, tile streaming
  ops/       blocks, PnP-ISTA (plain and the CUDA kernel), the NLM and BM3D
             denoisers, SVT, data fidelity, metrics (PSNR/SSIM), proxlib
  models/    the DIP model zoo behind get_net and the flax weight transplant
  solvers/   the ADMM engine, DIP trainer, early stopping, the lockstep
             (batched, seed-ensemble) engines, tiled scenes, the generic fit
  utils/     config presets, device selection, noise inputs, checkpoints,
             logging, profiling, figures
  native.py  ctypes bindings to the host library native/lrs_native.cc
  csrc/      hand-written CUDA kernels, built with nvcc at first use
"""

__version__ = "0.1.0"

from .api import inpaint, inpaint_scene  # noqa: E402

__all__ = ["inpaint", "inpaint_scene"]
