"""Carry flax parameters into the port's nets.

The port's `Skip` names its submodules as flax names their counterparts,
so the mapping is a rename plus two layout rules:

  * ``<path>/Conv2d_i/Conv_0/kernel`` (HWIO) -> ``<path>.Conv2d_i.weight`` (OIHW);
  * ``<path>/Conv2d_i/Conv_0/bias``          -> ``<path>.Conv2d_i.bias``;
  * ``<path>/BatchNorm2d_j/{scale,bias}``    -> ``<path>.BatchNorm2d_j.{weight,bias}``;
  * ``_SkipScale_0`` nests.

The port's `LipschitzUNet` is flat and follows the same idea:

  * ``SNConv2d_i/{kernel,bias}``       -> ``SNConv2d_i.{weight,bias}``;
  * ``SNBatchNorm2d_j/{scale,bias}``   -> ``SNBatchNorm2d_j.{weight,bias}``;
  * ``sn_state/SNConv2d_i/u``          -> ``SNConv2d_i.u`` (the power
    iteration's vector, ``sn_mode='power'`` only).

Both take numpy arrays only (a flax tree after ``np.asarray``), so this
package needs nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def skip_params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax `Skip` params tree of numpy arrays -> the port's `Skip` state dict."""
    state = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for name, sub in tree.items():
            if name.startswith("Conv2d_"):
                conv = sub["Conv_0"]
                kernel = np.asarray(conv["kernel"], dtype=np.float32)
                state[f"{prefix}{name}.weight"] = torch.from_numpy(
                    np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))
                )
                if "bias" in conv:
                    state[f"{prefix}{name}.bias"] = torch.from_numpy(
                        np.array(conv["bias"], dtype=np.float32)
                    )
            elif name.startswith("BatchNorm2d_"):
                state[f"{prefix}{name}.weight"] = torch.from_numpy(
                    np.array(sub["scale"], dtype=np.float32)
                )
                state[f"{prefix}{name}.bias"] = torch.from_numpy(
                    np.array(sub["bias"], dtype=np.float32)
                )
            elif name.startswith("_SkipScale_"):
                walk(sub, f"{prefix}{name}.")
            else:
                raise KeyError(f"unexpected flax module {prefix}{name}")

    walk(params, "")
    return state


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def lipschitz_unet_params_from_flax(
    params: Mapping, sn_state: Optional[Mapping] = None
) -> Dict[str, torch.Tensor]:
    """Flax `LipschitzUNet` variables as numpy arrays (``params`` and, for
    ``sn_mode='power'``, the ``sn_state`` collection) -> the port's
    `LipschitzUNet` state dict."""
    state = {}
    for name, sub in params.items():
        if name.startswith("SNConv2d_"):
            kernel = np.asarray(sub["kernel"], dtype=np.float32)  # HWIO -> OIHW
            state[f"{name}.weight"] = _tensor(kernel.transpose(3, 2, 0, 1))
            if "bias" in sub:
                state[f"{name}.bias"] = _tensor(sub["bias"])
        elif name.startswith("SNBatchNorm2d_"):
            state[f"{name}.weight"] = _tensor(sub["scale"])
            state[f"{name}.bias"] = _tensor(sub["bias"])
        else:
            raise KeyError(f"unexpected flax module {name}")
    for name, sub in (sn_state or {}).items():
        state[f"{name}.u"] = _tensor(sub["u"])
    return state
