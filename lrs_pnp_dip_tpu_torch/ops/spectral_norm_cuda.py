"""The spectral norms of a forward's convolution weights in one launch: a
hand-written CUDA kernel for Hopper (``csrc/spectral_norm.cu``).

It replaces no TPU kernel.  The 1-Lip U-Net's 14 spectrally normalised
convolutions each take sigma by 8 power steps a forward
(:func:`..models.lipschitz._sigma_max_power`), some 1,000 latency-bound
library kernels a forward on the card; the JAX package leaves that loop to
XLA.  The kernel runs every convolution's power iteration in one launch,
one thread-block cluster per convolution, each weight resident in its
cluster's shared memory for all its steps (see the note in the source).

:func:`plan_spectral_norm` picks the cluster size and the shared memory
from the (m, n) of the group's weights in plain Python, so the tiling is
testable without a card.  The source is built and loaded at the first
spectral norm on the card, as every hand-written kernel is
(:mod:`.cuda_kernel`); nothing is compiled or loaded when this module is
imported.
:meth:`SpectralNormKernel.launch` takes CUDA tensors only; a shape the plan
does not take raises, and so does a launch the card refuses.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

import torch

from .cuda_kernel import CSRC, MAX_SMEM_BYTES, HandWrittenKernel, check_operand, round_up

# Limits of csrc/spectral_norm.cu.
_THREADS = 256  # kThreads
MAX_GROUP = 64  # kMaxGroup: convolutions a launch
MAX_CLUSTER = 16
_COLS_PER_CTA = 144  # the plan's target: columns of W a CTA owns


def _seg(n: int, cluster_size: int) -> int:
    """Columns of W a CTA owns (``sn_seg``)."""
    return round_up(-(-n // cluster_size), 4)


def _ld(seg: int) -> int:
    """Row stride of the slice in shared memory, an odd number of float4s
    (``sn_ld``)."""
    ld = round_up(seg, 4)
    return ld if (ld // 4) % 2 else ld + 4


def smem_bytes(m: int, n: int, cluster_size: int) -> int:
    """Dynamic shared memory of one CTA for a weight of (m, n) split over
    ``cluster_size`` CTAs (``sn_layout``): the slice, u, the exchanged
    partial of u, the two products' partials, v, a scalar and the warps'
    sums, each padded to 16 bytes."""
    ld = _ld(_seg(n, cluster_size))
    mp = round_up(m, 4)
    return 4 * (m * ld + 2 * mp + max(mp, _THREADS) + max(ld, 4 * _THREADS) + ld + 4 + _THREADS // 32)


@dataclasses.dataclass(frozen=True)
class SnPlan:
    shapes: Tuple[Tuple[int, int], ...]  # (m, n) of each weight, in launch order
    cluster_size: int  # CTAs a convolution
    smem_bytes: int  # dynamic shared memory of each CTA: the largest weight's


def plan_spectral_norm(shapes: Sequence[Tuple[int, int]]) -> SnPlan:
    """The launch of a group of weights of ``shapes`` (m, n): clusters of
    the smallest power of two up to 16 that gives a CTA at most 144 columns
    of the widest weight (8 at the 1-Lip U-Net's n of 1152; 1 at width 16),
    and the shared memory of the largest slice.  Raises ``ValueError`` for a
    group the kernel does not take: empty, over ``MAX_GROUP`` weights, or a
    slice that does not fit one CTA's shared memory at 16 CTAs."""
    shapes = tuple((int(m), int(n)) for m, n in shapes)
    if not 1 <= len(shapes) <= MAX_GROUP:
        raise ValueError(f"the kernel takes 1 to {MAX_GROUP} weights a launch, got {len(shapes)}")
    if any(m < 1 or n < 1 for m, n in shapes):
        raise ValueError(f"every weight needs m, n >= 1, got {shapes}")
    widest = max(n for _, n in shapes)
    cluster_size = 1
    while cluster_size < MAX_CLUSTER and -(-widest // cluster_size) > _COLS_PER_CTA:
        cluster_size *= 2
    smem = max(smem_bytes(m, n, cluster_size) for m, n in shapes)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"a slice of {shapes} over {cluster_size} CTAs takes {smem} B of shared memory, "
            f"over the {MAX_SMEM_BYTES} B a CTA may use"
        )
    return SnPlan(shapes, cluster_size, smem)


class SpectralNormKernel(HandWrittenKernel):
    """Builds, loads and launches ``csrc/spectral_norm.cu``."""

    sources = (CSRC / "spectral_norm.cu",)
    signatures = {
        "lrs_pnp_sn_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2
                              + [ctypes.c_void_p], ctypes.c_int),
        "lrs_pnp_sn_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_int),
        "lrs_pnp_sn_max_group": ([], ctypes.c_int),
    }
    label = "spectral norm"

    def plan(self, shapes: Tuple[Tuple[int, int], ...]) -> SnPlan:
        """:func:`plan_spectral_norm`, kept per group of shapes and held to
        the kernel's own counts of weights and shared memory once."""
        if shapes not in self._plans:
            plan = plan_spectral_norm(shapes)
            lib = self.build()
            if lib.lrs_pnp_sn_max_group() != MAX_GROUP:
                raise RuntimeError(f"the kernel takes {lib.lrs_pnp_sn_max_group()} weights a launch, the plan {MAX_GROUP}")
            laid_out = max(lib.lrs_pnp_sn_smem_bytes(m, n, plan.cluster_size) for m, n in shapes)
            if laid_out != plan.smem_bytes:
                raise RuntimeError(f"the plan counts {plan.smem_bytes} B of shared memory, the kernel {laid_out}")
            self._plans[shapes] = plan
        return self._plans[shapes]

    def launch(
        self,
        weights: Sequence[torch.Tensor],  # each (m, n) f32, contiguous
        us: Sequence[torch.Tensor],  # each (m,) f32, contiguous: advanced in place
        ln_lambdas: Sequence[float],
        n_iters: Sequence[int],
    ) -> torch.Tensor:
        """Run every weight's power iteration in one launch on the current
        stream; returns (2, G) f32: sigma, then ``max(1, sigma /
        ln_lambda)``.  The first call builds the library; a call during a
        CUDA graph capture after the first of its group only records the
        launch, which keeps the pointers, ``ln_lambda`` and ``n_iter``."""
        G = len(weights)
        if not len(us) == len(ln_lambdas) == len(n_iters) == G:
            raise ValueError("needs one u, ln_lambda and n_iter per weight")
        if G == 0:
            raise ValueError("needs at least one weight")
        device = weights[0].device
        for g, (w, u) in enumerate(zip(weights, us)):
            check_operand(f"weight {g}", w, device)
            check_operand(f"u {g}", u, device)
            if w.ndim != 2 or tuple(u.shape) != (w.shape[0],):
                raise ValueError(f"weight {g} must be (m, n) and its u (m,), got {tuple(w.shape)}, {tuple(u.shape)}")
        if any(not ln > 0 for ln in ln_lambdas) or any(k < 0 for k in n_iters):
            raise ValueError(f"needs ln_lambda > 0 and n_iter >= 0, got {list(ln_lambdas)}, {list(n_iters)}")
        shapes = tuple((int(w.shape[0]), int(w.shape[1])) for w in weights)
        with torch.cuda.device(device):
            plan = self.plan(shapes)
            lib = self.build()
            out = torch.empty((2, G), dtype=torch.float32, device=device)
            err = lib.lrs_pnp_sn_launch(
                (ctypes.c_void_p * G)(*(w.data_ptr() for w in weights)),
                (ctypes.c_void_p * G)(*(u.data_ptr() for u in us)),
                (ctypes.c_int * G)(*(m for m, _ in shapes)),
                (ctypes.c_int * G)(*(n for _, n in shapes)),
                (ctypes.c_int * G)(*(int(k) for k in n_iters)),
                (ctypes.c_float * G)(*(float(ln) for ln in ln_lambdas)),
                G, out.data_ptr(), plan.cluster_size, plan.smem_bytes,
                torch.cuda.current_stream(device).cuda_stream,
            )
        self.launched(plan, err, G)
        return out


SN_KERNEL = SpectralNormKernel()
