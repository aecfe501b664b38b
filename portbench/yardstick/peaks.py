"""Published dense peaks of the cards the benchmark knows, and the card's
name and power limit as ``nvidia-smi`` reads them."""

from __future__ import annotations

import subprocess

# NVIDIA H100 SXM data sheet, dense rates: f32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth.  At the full power limit of 700 W; a card
# set lower runs slower under load, so every share is printed beside the
# card's limit.
H100_SXM = {"f32_flops": 67e12, "bf16_flops": 989e12, "bytes_per_s": 3.35e12}


def peaks_for(device_name: str):
    """The peaks of the card named ``device_name``, or None for a card the
    table does not hold (its rooflines and shares of peak are then left out)."""
    if "H100" in device_name and ("HBM3" in device_name or "SXM" in device_name):
        return H100_SXM
    return None


def power_limit() -> str:
    """``name, power.limit`` of the card as ``nvidia-smi`` gives them, or
    "not read" where it cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.splitlines()[0] if out else "not read"
