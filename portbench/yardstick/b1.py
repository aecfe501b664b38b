"""Kernel B1's least time: the fused PnP-ISTA loop over nB blocks of P
pixels against a (P, K) dictionary for ``n_iter`` iterations.

A copy of ``chip_smoke.py:bound_ms``'s arithmetic: two products of nB x P x K
multiply-adds per iteration (the prediction x D^T and the gradient's
residual times D), so 4 nB P K n_iter operations; each input read once (Y and
M, nB x P each; D, P x K; alpha, nB) and the coefficients (nB x K) written
once, in f32.  It counts the same work whatever tiling the kernel takes."""

from __future__ import annotations


def flops(nB: int, P: int, K: int, n_iter: int) -> int:
    return 4 * nB * P * K * n_iter


def io_bytes(nB: int, P: int, K: int) -> int:
    return (2 * nB * P + P * K + nB + nB * K) * 4


def bound_s(nB: int, P: int, K: int, n_iter: int, matmul_dtype: str, peaks: dict) -> float:
    """The larger of the operations over the operand type's peak rate and
    the bytes over the memory rate, in seconds."""
    peak = peaks["f32_flops"] if matmul_dtype == "float32" else peaks["bf16_flops"]
    return max(flops(nB, P, K, n_iter) / peak, io_bytes(nB, P, K) / peaks["bytes_per_s"])


# Kernels of one launch of B1: the loop itself, and the copies of D that the
# streaming tiers lay out first (csrc/ista.cu, csrc/ista_panel.cuh).
KERNEL_NAMES = ("pnp_ista_", "panel_images", "copy_d_rows", "copy_dt_rows")


def is_b1_kernel(name: str) -> bool:
    return any(k in name for k in KERNEL_NAMES)
