"""The three collectives of the sharded engine, over ``torch.distributed``
process groups, each counting the bytes it brings to this rank.

Every function takes ``group=None``, or a group of one rank, as "no peers"
and then returns its input itself: the sharded code paths run unsharded
with the same bits.  Gloo takes CUDA tensors for all three (checked on an
H100 with torch 2.11, two and four ranks on one card), so the tensors go to
the collective where they are, host or card, with no staging.

:data:`TRAFFIC` counts, per rank, the calls that had peers and the bytes
that came from other ranks: for an all_gather the other ranks' parts, for
an all_reduce the tensor (the sum of the other ranks' contributions), for a
broadcast the tensor on every rank but the source.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class Traffic:
    """Collective calls with peers and the bytes they brought, per rank."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0

    def add(self, t: torch.Tensor, parts: int = 1) -> None:
        self.calls += 1
        self.bytes += parts * t.numel() * t.element_size()


TRAFFIC = Traffic()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks (a new tensor)."""
    if group_size(group) == 1:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    TRAFFIC.add(out)
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors, all of one shape, concatenated along ``dim`` in
    the order of their ranks in the group."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    TRAFFIC.add(t, n - 1)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of the rank ``src`` (a global rank) on every rank of the group."""
    if group_size(group) == 1:
        return t
    out = t.contiguous().clone()
    dist.broadcast(out, src=src, group=group)
    if dist.get_rank() != src:
        TRAFFIC.add(out)
    return out


def group_rank(group: Optional[object]) -> int:
    """This rank's index in ``group`` (0 without peers)."""
    return 0 if group_size(group) == 1 else dist.get_rank(group)
