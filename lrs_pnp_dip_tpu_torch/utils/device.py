"""Device selection for the port's entry points.

Entry points run on the card (``"cuda"``) unless the caller asks for the
CPU.  Without a card they raise: they never carry on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return the ``torch.device`` to run on, or raise if it is a CUDA
    device and no card is present.

    On the card this also turns TF32 off for matrix products and cuDNN
    convolutions: the solver's configs are float32, and cuDNN would
    otherwise run f32 convolutions in TF32 (about three decimal digits),
    which the JAX package's f32 semantics do not allow."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
