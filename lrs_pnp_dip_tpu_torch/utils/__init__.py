from .config import (
    PRESETS,
    DipConfig,
    SolverConfig,
    SparseProxConfig,
    dip_preset,
)
from .device import resolve_device

__all__ = [
    "PRESETS",
    "DipConfig",
    "SolverConfig",
    "SparseProxConfig",
    "dip_preset",
    "resolve_device",
]
