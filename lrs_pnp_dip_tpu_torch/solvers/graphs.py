"""CUDA graphs of the device-resident solve (the counterpart of the JAX
package's ``lax.scan`` / ``lax.while_loop`` loops).

:class:`Captured` holds a function of static tensors: tensors that keep
their storage from one call to the next, which the function reads and
writes in place.  On the card its first call runs the function eagerly on a
side stream: real work, and the warm-up that builds kernel B1 and lets
cuBLAS, cuDNN and the autograd engine set themselves up outside a capture.
The second call captures the function into a ``torch.cuda.CUDAGraph``, and
that call and every later one replays the graph and returns the tensors the
capture returned, which the replay refills.  On the CPU every call runs the
function eagerly: the plain version, which the tests hold to the JAX
package.  Each replay adds the launches the graph holds of each
hand-written kernel to that kernel's count (``ops/cuda_kernel.py``).
A capture that fails raises; nothing falls back to eager
execution on the card.  The warm-up and the capture run with cuDNN's
deterministic algorithms, as every DIP fit does, so that a replay gives the
bits of the eager run.  The capture runs with Python's cyclic garbage
collector paused: a dead graph that the collector frees during a capture
makes CUDA calls that a capture forbids, and the capture fails.
"""

from __future__ import annotations

import gc
from typing import Callable

import torch

from ..ops.cuda_kernel import capture_marks, held_since
from ..utils.device import deterministic_cudnn


class Captured:
    """``fn()`` captured once and replayed on the card, run eagerly on the CPU."""

    def __init__(self, fn: Callable, device):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.out = None
        self.held = {}  # hand-written kernel -> (its launches the graph holds, the tiling of the last)
        self._warm = False

    def __call__(self):
        if self.device.type != "cuda":
            return self.fn()
        if self.graph is None:
            if not self._warm:
                self._warm = True
                return self._on_side_stream()
            self._capture()
        self.graph.replay()
        for kernel, (n, plan) in self.held.items():
            kernel.replayed(n, plan)
        return self.out

    def launches_of(self, kernel) -> tuple:
        """(launches of the hand-written ``kernel`` the graph holds, the
        tiling of the last of them): (0, None) for one it does not hold."""
        return self.held.get(kernel, (0, None))

    @deterministic_cudnn()
    def _on_side_stream(self):
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn()
        current.wait_stream(side)
        return out

    @deterministic_cudnn()
    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        marks = capture_marks()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                out = self.fn()
        finally:
            if collecting:
                gc.enable()
        self.graph, self.out = graph, out
        self.held = held_since(marks)

    def reset(self) -> None:
        """Drop the graph (the function's tensors changed): the next call
        captures anew."""
        self.graph = self.out = None
