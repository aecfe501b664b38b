"""Explicit collective implementations of the distributed proxes
(counterpart of ``lrs_pnp_dip_tpu/parallel/collectives.py``).

The SVT of the row-sharded iterate is the one stage with cross-shard
structure: ``G = X^T X`` sums over the sharded pixel rows.
:func:`distributed_svt` computes the local Gram on each rank, all_reduces
the B x B result over ``patch`` (B*B*4 bytes), eigendecomposes it on every
rank and applies the spectral filter to the local rows; X is never gathered.

The functions named ``distributed_*`` take and return this rank's piece
(the JAX versions' bodies inside ``shard_map``); the ``make_*`` functions
return drop-ins that take and return whole tensors, equal on every rank
(the JAX versions' ``shard_map`` wrappers): they cut the rank's piece,
compute, and gather the result.

The 1-D sparse prox codes the rank's share of the blocks, which is one
launch of kernel B1 per rank on the card.  The
2-D sparse prox runs the plain loop with one all_reduce of the partial
gradient per iteration, on the card too: the JAX package runs
``pnp_ista_blocks_impl`` there, not its Pallas kernel, and B1 cannot
all_reduce inside its iteration.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..ops.ista import compute_alpha, pnp_ista_blocks, sparse_coefs
from ..ops.svt import _gram_spectral_filter
from ..utils.comm import all_gather, all_reduce
from .mesh import axis_group, axis_index, axis_size
from .sharding import shard, unshard


def distributed_gram(X_local: torch.Tensor, mesh: DeviceMesh, axis: str = "patch") -> torch.Tensor:
    """Local Gram of the rows ``(..., P_local, B)``, summed over ``axis``."""
    return all_reduce(X_local.transpose(-1, -2) @ X_local, axis_group(mesh, (axis,)))


def distributed_svt(X_local: torch.Tensor, tau, mesh: DeviceMesh, axis: str = "patch") -> torch.Tensor:
    """SVT of a row-sharded ``(..., P_local, B)`` iterate; returns the same
    rows of the result.  With one rank it is :func:`..ops.svt.svt_gram`, bit
    for bit."""
    V, ratio = _gram_spectral_filter(distributed_gram(X_local, mesh, axis), tau)
    return ((X_local @ V) * ratio[..., None, :]) @ V.transpose(-1, -2)


def distributed_svt_2d(
    X_local: torch.Tensor, tau, mesh: DeviceMesh, patch_axis: str = "patch", band_axis: str = "band"
) -> torch.Tensor:
    """SVT of an iterate sharded over pixel rows AND band columns, local
    tiles ``(..., P/p, B/b)``.  Collectives per call: one all_gather of the
    tile over ``band`` (the rank's full row slab), one all_reduce of the
    B x B Gram over ``patch``; the eigendecomposition and the filter run on
    every rank, and the recompose ``Xg @ W[:, cols]`` keeps the rank's own
    band columns, so the output is a tile like the input."""
    Xg = all_gather(X_local, axis_group(mesh, (band_axis,)), dim=-1)
    G = all_reduce(Xg.transpose(-1, -2) @ Xg, axis_group(mesh, (patch_axis,)))
    V, ratio = _gram_spectral_filter(G, tau)
    W = (V * ratio[..., None, :]) @ V.transpose(-1, -2)
    cols = X_local.shape[-1]
    return Xg @ W[..., axis_index(mesh, band_axis) * cols : (axis_index(mesh, band_axis) + 1) * cols]


def _rows_spec(X: torch.Tensor, *axes) -> tuple:
    """The spec of a ``(..., P, B)`` matrix split over ``axes`` on its last two dims."""
    return (None,) * (X.ndim - 2) + axes


def make_distributed_svt(mesh: DeviceMesh, axis: str = "patch") -> Callable:
    """A drop-in for :func:`..ops.svt.svt_gram` over ``mesh``: rows over
    ``axis``.  Takes and returns the whole ``(..., P, B)`` iterate."""

    def svt_fn(X, tau):
        spec = _rows_spec(X, axis, None)
        return unshard(distributed_svt(shard(X, spec, mesh), tau, mesh, axis), spec, mesh)

    return svt_fn


def make_distributed_svt_2d(
    mesh: DeviceMesh, patch_axis: str = "patch", band_axis: str = "band"
) -> Callable:
    """A drop-in for :func:`..ops.svt.svt_gram` over a 2-D {patch, band}
    mesh: rows over ``patch_axis``, columns over ``band_axis``."""

    def svt_fn(X, tau):
        spec = _rows_spec(X, patch_axis, band_axis)
        tile = distributed_svt_2d(shard(X, spec, mesh), tau, mesh, patch_axis, band_axis)
        return unshard(tile, spec, mesh)

    return svt_fn


def make_sharded_sparse_prox(mesh: DeviceMesh, cfg, axis: str = "patch") -> Callable:
    """The sparse prox with the block axis split over ``axis``.

    ``prox(blocks, mask_blocks, D, alpha=None)`` takes and returns whole
    tensors.  The blocks are padded to a multiple of the axis size with
    fully masked rows (zero coefficients; a caller's alpha is padded with
    1.0), each rank codes its rows (:func:`..ops.ista.sparse_coefs`: one
    launch of kernel B1 on the card, the MATLAB twin's ``parfor``), and the
    coefficients are gathered, the padding sliced away and the blocks
    reconstructed with the whole dictionary on every rank.  The JAX version
    gathers reconstructed rows; gathering the (nB, K) coefficients moves
    K / P of the bytes (512 / 1296 at the reference shape), and the one
    reconstruction over all rows gives the unsharded prox's bits wherever
    B1's rows do (a cuBLAS product over half the rows may sum in another
    order).  No collective runs inside the loop."""
    group = axis_group(mesh, (axis,))
    n = axis_size(mesh, axis)
    me = axis_index(mesh, axis)

    def prox(blocks, mask_blocks, D, alpha=None):
        nB = blocks.shape[0]
        pad = (-nB) % n
        if pad:
            blocks = F.pad(blocks, (0, 0, 0, pad))
            mask_blocks = F.pad(mask_blocks, (0, 0, 0, pad))
        if alpha is None:
            alpha = compute_alpha(D, mask_blocks, cfg)
        elif pad:
            alpha = F.pad(alpha, (0, pad), value=1.0)
        rows = (nB + pad) // n
        mine = slice(me * rows, (me + 1) * rows)
        coefs = sparse_coefs(blocks[mine], mask_blocks[mine], D, cfg, alpha=alpha[mine])
        return all_gather(coefs, group, 0)[:nB] @ D.to(torch.float32).T

    return prox


def make_sharded_sparse_prox_2d(
    mesh: DeviceMesh, cfg, patch_axis: str = "patch", band_axis: str = "band"
) -> Callable:
    """The sparse prox over a 2-D {patch, band} mesh: block rows over
    ``patch_axis`` AND pixel columns (the dictionary's rows) over
    ``band_axis``.

    Each rank holds an (nB/p, P/b) tile and a (P/b, K) slice of D and runs
    the plain loop (:func:`..ops.ista.pnp_ista_blocks` with the band group),
    whose gradient takes one all_reduce of the (nB/p, K) partial over
    ``band`` per iteration; the coefficients are equal across the band
    group, and ``coefs @ D_local.T`` gives the rank's own pixel columns.
    The tiles are gathered back.  Fully masked padding rows give zero
    coefficients, and zero dictionary rows add nothing to any sum."""
    patch_group = axis_group(mesh, (patch_axis,))
    band_group = axis_group(mesh, (band_axis,))
    p, b = axis_size(mesh, patch_axis), axis_size(mesh, band_axis)
    ip, ib = axis_index(mesh, patch_axis), axis_index(mesh, band_axis)

    def prox(blocks, mask_blocks, D, alpha=None):
        nB, P = blocks.shape
        if alpha is None:
            alpha = compute_alpha(D, mask_blocks, cfg)
        pad_b, pad_p = (-nB) % p, (-P) % b
        if pad_b or pad_p:
            blocks = F.pad(blocks, (0, pad_p, 0, pad_b))
            mask_blocks = F.pad(mask_blocks, (0, pad_p, 0, pad_b))
            D = F.pad(D, (0, 0, 0, pad_p))
            alpha = F.pad(alpha, (0, pad_b), value=1.0)
        rows = slice(ip * ((nB + pad_b) // p), (ip + 1) * ((nB + pad_b) // p))
        cols = slice(ib * ((P + pad_p) // b), (ib + 1) * ((P + pad_p) // b))
        D_local = D[cols].to(torch.float32)
        coefs = pnp_ista_blocks(
            blocks[rows, cols], mask_blocks[rows, cols], D_local, cfg, alpha=alpha[rows],
            group=band_group,
        )
        tile = coefs @ D_local.T
        whole = all_gather(all_gather(tile, band_group, 1), patch_group, 0)
        return whole[:nB, :P]

    return prox
