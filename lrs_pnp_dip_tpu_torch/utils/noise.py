"""DIP input helpers (counterpart of ``lrs_pnp_dip_tpu/utils/noise.py``;
reference ``utils/common_utils.py:155-273``).

``get_noise``: a uniform or normal noise input, 2-D ``(1, H, W, C)`` or 3-D
``(1, D, H, W, C)`` (NHWC / NDHWC, the layout of the port's nets), scaled by
``var`` (the reference multiplies by 1/10), or a 2-channel coordinate grid.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .device import resolve_device


def get_noise(
    generator: Optional[torch.Generator],
    input_depth: int,
    spatial_size: Sequence[int],
    method: str = "noise",
    noise_type: str = "u",
    var: float = 0.1,
    device=None,
) -> torch.Tensor:
    """Noise (or meshgrid) DIP input, float32.

    method 'noise': a random tensor (1, *spatial, input_depth) drawn from
    ``generator``; method 'meshgrid': the normalised 2-channel coordinate
    grid, which draws nothing.  Made on ``device``: by default the
    generator's, else the card, which raises when there is none.
    """
    device = resolve_device(device or (generator.device if generator is not None else "cuda"))
    if method == "noise":
        shape = (1, *spatial_size, input_depth)
        if noise_type == "u":
            x = torch.rand(shape, generator=generator, device=device)
        elif noise_type == "n":
            x = torch.randn(shape, generator=generator, device=device)
        else:
            raise ValueError(noise_type)
        return x * var
    if method == "meshgrid":
        if input_depth != 2 or len(spatial_size) != 2:
            raise ValueError("meshgrid needs input_depth 2 and a 2-D spatial size")
        h, w = spatial_size
        yy, xx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device) / float(h - 1),
            torch.arange(w, dtype=torch.float32, device=device) / float(w - 1),
            indexing="ij",
        )
        return torch.stack([yy, xx], dim=-1)[None]
    raise ValueError(method)
