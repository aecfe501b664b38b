"""What the port's hand-written CUDA kernels share: the build, the launch
accounting, and the launches a captured CUDA graph holds of each.

A kernel is a source under ``csrc/`` with a plain C interface, built by
:func:`build_library` at its first use and loaded with ``ctypes``; nothing
is compiled or loaded when this module is imported.  Its wrapper subclasses
:class:`HandWrittenKernel`, whose instances register themselves, so that a
capture (``solvers/graphs.py``) learns the launches it holds from
:func:`capture_marks` and :func:`held_since`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import weakref
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may use on sm_90


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build_library(sources, flags, stem: str, build_dir: Path = CSRC / "build"):
    """Compile ``sources[0]`` (which includes the rest) with ``nvcc`` and
    ``flags`` into ``build_dir/lib<stem>_<hash>.so``, the hash of the
    sources and flags, unless that library is there; then load it with
    ``ctypes``.  Returns the library and nvcc's output ("" where the
    library was built already)."""
    digest = hashlib.sha256(
        b"".join(path.read_bytes() for path in sources) + " ".join(flags).encode()
    ).hexdigest()[:16]
    lib_path = build_dir / f"lib{stem}_{digest}.so"
    log = ""
    if not lib_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(sources[0])], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building {sources[0]}:\n{log}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path)), log


def round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def check_operand(name: str, t: torch.Tensor, device: torch.device, shape: tuple | None = None) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor on the CUDA
    ``device``, of ``shape`` where given: the kernels take raw pointers."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be on the CUDA device {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_KERNELS = weakref.WeakSet()  # every live HandWrittenKernel


class HandWrittenKernel:
    """Builds the library of ``sources`` (``sources[0]`` includes the rest
    and names it), binds the C functions of ``signatures`` ({name:
    (argument types, result type)}) and counts the launches: ``launches``
    one per launch outside a CUDA graph capture, and the launches a captured
    graph holds each time it is replayed (:meth:`replayed`); ``captured``
    one per launch recorded into a graph instead; ``last_plan`` the tiling
    of the latest launch, replays included."""

    sources: tuple = ()
    signatures: dict = {}
    label = "hand-written"  # names the kernel in the error of a refused launch

    def __init__(self, flags: tuple = NVCC_FLAGS):
        self.flags = tuple(flags)
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None
        self._plans: dict = {}  # the plans made so far, by shape
        self.reset_counts()
        _KERNELS.add(self)

    def build(self) -> ctypes.CDLL:
        """Compile the sources if their library is not built yet, then load it."""
        if self._lib is None:
            lib, self.build_log = build_library(self.sources, self.flags, self.sources[0].stem)
            self._bind(lib)
            self._lib = lib
        return self._lib

    def _bind(self, lib: ctypes.CDLL) -> None:
        for name, (argtypes, restype) in self.signatures.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = restype

    def reset_counts(self) -> None:
        self.launches = 0
        self.captured = 0
        self.last_plan = None

    def _count(self, n: int, plan) -> None:
        self.launches += n

    def launched(self, plan, err: int, n_clusters: int) -> None:
        """Raise if the card refused the launch of ``plan`` (``err``, a
        cudaError_t), else count it."""
        if err != 0:
            raise RuntimeError(
                f"{self.label} kernel launch refused: cudaError_t {err} for {n_clusters} clusters "
                f"of {plan.cluster_size} CTAs with {plan.smem_bytes} B of shared memory each"
            )
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self._count(1, plan)
        self.last_plan = plan

    def replayed(self, n: int, plan) -> None:
        """Count the ``n`` launches of a captured graph that was just
        replayed, the last of them with the tiling ``plan``."""
        self._count(n, plan)
        self.last_plan = plan


def capture_marks() -> dict:
    """Each kernel's count of captured launches, taken before a capture."""
    return {kernel: kernel.captured for kernel in _KERNELS}


def held_since(marks: dict) -> dict:
    """{kernel: (its launches captured since ``marks``, the tiling of the
    last)} for every kernel that a capture recorded since ``marks``."""
    counts = {kernel: kernel.captured - marks.get(kernel, 0) for kernel in list(_KERNELS)}
    return {kernel: (n, kernel.last_plan) for kernel, n in counts.items() if n > 0}
