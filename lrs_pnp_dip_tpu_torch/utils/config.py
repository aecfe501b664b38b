"""Configuration dataclasses and per-variant presets.

Counterpart of ``lrs_pnp_dip_tpu/utils/config.py`` (and of
``SparseProxConfig`` in ``lrs_pnp_dip_tpu/ops/ista.py``): the same frozen
dataclasses with the same fields and defaults, and all seven presets with
the same values, so a config means the same solve in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional


@dataclasses.dataclass(frozen=True)
class SparseProxConfig:
    """Static configuration of the sparse-coding stage."""

    lambda_ista: float = 0.1
    n_iter: int = 100  # reference Nit: 100 (DIP variants), 80 (plain)
    alpha_mode: Literal["trace4", "specnorm"] = "trace4"
    h_scale: float = 1.0  # reference: 1.0 (DIP variants), 0.1 (plain)
    power_iters: int = 50  # for alpha_mode == "specnorm"
    patch_size: int = 3
    patch_distance: int = 3
    backend: Literal["auto", "xla", "pallas"] = "auto"
    # 'auto' and 'pallas' run kernel B1 (csrc/ista.cu) for tensors on the
    # card with the nlm_fast denoiser; 'xla' runs the plain PyTorch loop on
    # any device (``ops.ista.use_kernel``), the way around a shape the
    # kernel's plan refuses.  CPU tensors and the other denoisers always run
    # the plain loop.
    matmul_dtype: Literal["float32", "bfloat16"] = "float32"
    # 'bfloat16': the two matrix products per ISTA iteration take bf16
    # operands and accumulate in f32; the NLM, step sizes and the carried
    # coefficients stay f32.
    denoiser: Literal["nlm_fast", "nlm_classic", "bm3d"] = "nlm_fast"


@dataclasses.dataclass(frozen=True)
class DipConfig:
    """DIP training hyper-parameters (reference defaults:
    ``get_DIP_out`` num_iter=5000, lr=0.1, show_every=1 and the
    EarlyStop buffer 30 / patience 60, ``main_LRS_PnP_DIP_pro.py:211-231``).
    """

    num_iter: int = 5000
    learning_rate: float = 0.1
    show_every: int = 1
    buffer_size: int = 30
    patience: int = 60
    compute_dtype: str = "float32"
    es_mode: str = "exact"
    input_mode: str = "iterate"
    noise_var: float = 0.1
    return_mode: str = "last"  # 'last' | 'window_mean'


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Full configuration of one LRS-PnP(-DIP) solve."""

    variant: str = "dip"  # 'lrs_pnp' | 'dip' | 'dip_1lip'
    gamma: float = 0.5  # data-fidelity weight
    mu1: float = 0.1  # sparsity penalty
    mu2: float = 0.1  # low-rank penalty
    outer_iters: int = 250  # iteration_num
    block_size: int = 36  # bb
    stride: int = 36  # slidingDis
    sparse: SparseProxConfig = SparseProxConfig()
    dip: Optional[DipConfig] = DipConfig()
    dip_net: str = "default"
    net_width: int = 128
    ln_lambda: float = 1.0  # Lipschitz bound (1-Lip variant)
    sn_mode: str = "power"  # spectral-norm estimator
    seed: int = 0
    dtype: str = "float32"


def lrs_pnp_preset(**overrides) -> SolverConfig:
    """Classic LRS-PnP (SVT low-rank prox, no DIP) —
    reference ``main_LRS_PnP.py:217-238``."""
    cfg = SolverConfig(
        variant="lrs_pnp",
        mu1=0.15,
        mu2=0.15 * 6,
        outer_iters=2,
        sparse=SparseProxConfig(n_iter=80, alpha_mode="specnorm", h_scale=0.1),
        dip=None,
    )
    return dataclasses.replace(cfg, **overrides)


def matlab_preset(**overrides) -> SolverConfig:
    """The MATLAB LRS-PnP twin — ``main_LRS_PnP.m:57-70``."""
    cfg = SolverConfig(
        variant="lrs_pnp",
        gamma=0.5,
        mu1=0.15,
        mu2=0.15,
        outer_iters=13,
        sparse=SparseProxConfig(
            n_iter=80,
            alpha_mode="specnorm",
            h_scale=0.1,
            denoiser="nlm_classic",
            backend="xla",
        ),
        dip=None,
    )
    return dataclasses.replace(cfg, **overrides)


def dip_preset(**overrides) -> SolverConfig:
    """LRS-PnP-DIP — reference ``main_LRS_PnP_DIP_pro.py:324-353``:
    mu1 = mu2 = 0.1, Nit = 100, alpha = 4*trace, 250 outer iterations,
    DIP: skip-128 net, Adam lr 0.1, <=5000 iters, ES window 30/patience 60."""
    cfg = SolverConfig(
        variant="dip",
        mu1=0.1,
        mu2=0.1,
        outer_iters=250,
        sparse=SparseProxConfig(n_iter=100, alpha_mode="trace4", h_scale=1.0),
        dip=DipConfig(),
    )
    return dataclasses.replace(cfg, **overrides)


def dip_1lip_preset(**overrides) -> SolverConfig:
    """LRS-PnP-DIP(1-Lip) — reference ``main_LRS_PnP_DIP_1-LiP.py``."""
    cfg = dataclasses.replace(dip_preset(), variant="dip_1lip", ln_lambda=1.0)
    return dataclasses.replace(cfg, **overrides)


def dip_tuned_preset(**overrides) -> SolverConfig:
    """LRS-PnP-DIP retuned for the shipped dictionary: mu1 0.01,
    window-mean DIP return, patience 150."""
    base = dip_preset(mu1=0.01)
    cfg = dataclasses.replace(
        base, dip=dataclasses.replace(base.dip, return_mode="window_mean", patience=150)
    )
    return dataclasses.replace(cfg, **overrides)


def dip_1lip_tuned_preset(**overrides) -> SolverConfig:
    """LRS-PnP-DIP(1-Lip) with the same retuned balance as `dip_tuned`."""
    cfg = dataclasses.replace(dip_tuned_preset(), variant="dip_1lip", ln_lambda=1.0)
    return dataclasses.replace(cfg, **overrides)


def dip_fast_preset(**overrides) -> SolverConfig:
    """`dip_tuned` with bf16 operands in the sparse-prox products and the
    DIP forward/backward, and the incremental early-stop evaluator."""
    base = dip_tuned_preset()
    cfg = dataclasses.replace(
        base,
        sparse=dataclasses.replace(base.sparse, matmul_dtype="bfloat16"),
        dip=dataclasses.replace(
            base.dip, compute_dtype="bfloat16", es_mode="incremental"
        ),
    )
    return dataclasses.replace(cfg, **overrides)


PRESETS = {
    "lrs_pnp": lrs_pnp_preset,
    "matlab": matlab_preset,
    "dip": dip_preset,
    "dip_1lip": dip_1lip_preset,
    "dip_tuned": dip_tuned_preset,
    "dip_1lip_tuned": dip_1lip_tuned_preset,
    "dip_fast": dip_fast_preset,
}
