"""Carry flax `Skip` parameters into the port's `Skip`.

The port's `Skip` names its submodules as flax names their counterparts,
so the mapping is a rename plus two layout rules:

  * ``<path>/Conv2d_i/Conv_0/kernel`` (HWIO) -> ``<path>.Conv2d_i.weight`` (OIHW);
  * ``<path>/Conv2d_i/Conv_0/bias``          -> ``<path>.Conv2d_i.bias``;
  * ``<path>/BatchNorm2d_j/{scale,bias}``    -> ``<path>.BatchNorm2d_j.{weight,bias}``;
  * ``_SkipScale_0`` nests.

It takes numpy arrays only (a flax params tree after ``np.asarray``), so
this package needs nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

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
