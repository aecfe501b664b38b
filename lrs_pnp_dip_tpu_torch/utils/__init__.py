from .config import (
    PRESETS,
    DipConfig,
    SolverConfig,
    SparseProxConfig,
    dip_1lip_preset,
    dip_preset,
    lrs_pnp_preset,
)
from .device import resolve_device
from .noise import get_noise

__all__ = [
    "PRESETS",
    "DipConfig",
    "SolverConfig",
    "SparseProxConfig",
    "dip_1lip_preset",
    "dip_preset",
    "get_noise",
    "lrs_pnp_preset",
    "resolve_device",
]
