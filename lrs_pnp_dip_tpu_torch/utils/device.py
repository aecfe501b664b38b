"""Device selection for the port's entry points.

Entry points run on the card (``"cuda"``) unless the caller asks for the
CPU.  Without a card they raise: they never carry on quietly on the CPU.
"""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def deterministic_cudnn():
    """Run the block with cuDNN's deterministic algorithms, chosen by its
    heuristics (``cudnn.deterministic`` on, ``cudnn.benchmark`` off), and
    give the caller's flags back after it.

    Every DIP fit runs under it, eager, graphed (its capture included) and
    channel-parallel, so that a fit repeats bit for bit on the card as the
    JAX package's repeats on a TPU: some of cuDNN's algorithms sum with
    atomics.  A scope, not a setting of :func:`resolve_device`, because the
    flags are global to the process and the caller's own convolutions keep
    what it chose for them.  cuDNN keys the algorithms it keeps per shape by
    these flags, so choices made outside the scope are not reused inside."""
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
