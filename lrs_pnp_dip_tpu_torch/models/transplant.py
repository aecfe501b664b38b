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

:func:`params_from_flax` does the same for any net of the zoo whose
submodules carry flax's names (:class:`~.common.ZooModule`): it walks the
flax tree by name and takes its layout from the leaf's name and rank.

All take numpy arrays only (a flax tree after ``np.asarray``), so this
package needs nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


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


def params_from_flax(params: Mapping, net: nn.Module) -> Dict[str, torch.Tensor]:
    """A flax ``params`` tree of numpy arrays -> the state dict of ``net``,
    the port's counterpart of the flax module.

    Scopes map to submodules of the same name, with one exception: the
    ``Conv_0`` inside a flax ``Conv2d_<n>`` wrapper is the port's
    ``Conv2d_<n>`` itself.  Leaves:

      * ``kernel`` -> ``weight``, the two feature axes moved to the front:
        conv HWIO -> OIHW, DHWIO -> OIDHW, ``Dense`` (in, out) -> (out, in);
      * ``scale`` (BatchNorm, LayerNorm) -> ``weight``;
      * any other leaf (``bias``, ``bn_scale_0``, ...) keeps its name.

    Raises ``KeyError`` for a flax parameter the net has no place for and
    for a parameter of the net the tree does not give, ``ValueError`` for a
    shape that does not fit."""
    expected = net.state_dict()
    state = {}

    def walk(tree: Mapping, path: list) -> None:
        for name, sub in tree.items():
            if isinstance(sub, Mapping):
                nested = name == "Conv_0" and path and path[-1].startswith("Conv2d_")
                walk(sub, path if nested else path + [name])
                continue
            a = np.asarray(sub, dtype=np.float32)
            leaf = {"kernel": "weight", "scale": "weight"}.get(name, name)
            if name == "kernel":
                a = a.transpose((a.ndim - 1, a.ndim - 2) + tuple(range(a.ndim - 2)))
            key = ".".join(path + [leaf])
            if key not in expected:
                raise KeyError(
                    f"flax parameter {'/'.join(path + [name])} has no counterpart {key!r} "
                    f"in {type(net).__name__}"
                )
            if tuple(expected[key].shape) != a.shape:
                raise ValueError(f"{key}: flax shape {a.shape}, port shape {tuple(expected[key].shape)}")
            state[key] = torch.from_numpy(np.ascontiguousarray(a))

    walk(params, [])
    missing = sorted(set(dict(net.named_parameters())) - set(state))
    if missing:
        raise KeyError(f"the flax tree gives no value for {missing}")
    return state
