"""Kernel B1: the fused PnP-ISTA loop as a hand-written CUDA kernel for
Hopper (``csrc/ista.cu``), the port of the TPU kernel
``lrs_pnp_dip_tpu/ops/ista_pallas.py:pnp_ista_blocks_pallas``.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (into ``csrc/build/``, named by the
hash of the source and flags) and loaded with ``ctypes``.  Nothing is
compiled or loaded when this module is imported.

:func:`.ista.pnp_ista_blocks_fused` prepares the kernel's inputs and
calls :meth:`FusedIstaKernel.launch`, which takes CUDA tensors only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
_MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may use on sm_90


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


class FusedIstaKernel:
    """Builds, loads and launches ``csrc/ista.cu``.

    ``launches`` counts the launches of the fused loop: one per call that
    reaches the kernel, and nothing else adds to it."""

    source = _CSRC / "ista.cu"
    build_dir = _CSRC / "build"

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(_NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return self.build_dir / f"libista_{digest}.so"

    def build(self) -> ctypes.CDLL:
        """Compile the source if its library is not built yet, then load it."""
        if self._lib is not None:
            return self._lib
        lib_path = self.library_path()
        if not lib_path.exists():
            self.build_dir.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(self.source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {self.source}:\n"
                    f"{self.build_log}"
                )
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        ptr, c_int = ctypes.c_void_p, ctypes.c_int
        lib.lrs_pnp_ista_launch.argtypes = [ptr] * 8 + [c_int] * 5 + [ptr]
        lib.lrs_pnp_ista_launch.restype = c_int
        lib.lrs_pnp_ista_smem_bytes.argtypes = [c_int, c_int]
        lib.lrs_pnp_ista_smem_bytes.restype = c_int
        self._lib = lib
        return lib

    def launch(
        self,
        ym: torch.Tensor,  # (nB, P) pre-masked targets
        m: torch.Tensor,  # (nB, P) mask
        d: torch.Tensor,  # (P, K) dictionary
        inv_alpha: torch.Tensor,  # (nB,)
        nih: torch.Tensor,  # (nB,) -1 / (9 h^2)
        n_iter: int,
        bf16: bool,
    ) -> torch.Tensor:
        """Run the fused loop on the current stream; returns x (nB, K)."""
        nB, P = ym.shape
        K = d.shape[1]
        device = ym.device
        for name, t, shape in (
            ("ym", ym, (nB, P)), ("m", m, (nB, P)), ("d", d, (P, K)),
            ("inv_alpha", inv_alpha, (nB,)), ("nih", nih, (nB,)),
        ):
            if t.device != device or t.device.type != "cuda":
                raise ValueError(f"{name} must be on the CUDA device {device}, got {t.device}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if nB < 1 or K < 6 or n_iter < 0:
            raise ValueError(f"needs nB >= 1, K >= 6 and n_iter >= 0 (nB={nB}, K={K}, n_iter={n_iter})")
        lib = self.build()
        smem = lib.lrs_pnp_ista_smem_bytes(P, K)
        if smem > _MAX_SMEM_BYTES:
            raise ValueError(f"P={P}, K={K} need {smem} B of shared memory (> {_MAX_SMEM_BYTES})")
        out = torch.empty((nB, K), dtype=torch.float32, device=device)
        dt = torch.empty((K, P), dtype=torch.float32, device=device)
        dm = torch.empty((P, K), dtype=torch.float32, device=device) if bf16 else None
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.lrs_pnp_ista_launch(
                ym.data_ptr(), m.data_ptr(), d.data_ptr(), inv_alpha.data_ptr(),
                nih.data_ptr(), dt.data_ptr(), None if dm is None else dm.data_ptr(), out.data_ptr(),
                nB, P, K, int(n_iter), int(bool(bf16)), stream,
            )
        if err != 0:
            raise RuntimeError(f"pnp_ista kernel launch failed: cudaError_t {err}")
        self.launches += 1
        return out


ISTA_KERNEL = FusedIstaKernel()
