"""Tensor (model) parallelism for the DIP nets: channel sharding over the
``model`` axis (counterpart of ``lrs_pnp_dip_tpu/parallel/tensor.py``).

The layout is the JAX package's: a conv kernel is split by its output
channels, which in torch's OIHW layout are dim 0 (flax's HWIO has them
last), and a per-feature vector (a bias, a batch norm's scale and shift) is
split too, when the axis size divides it; everything else is whole on
every rank.  GSPMD inserts the collectives in the JAX package; here they
are placed by hand, after Megatron's column-parallel layer with a gathered
output, as two autograd functions:

  * on the input of a split module: the identity forward, an all_reduce of
    the input's gradient backward (each rank's output channels contribute
    part of it);
  * on its output: an all_gather of the channels forward, the rank's own
    channels of the gradient backward.

So the activations between split modules are whole on every rank, and a
whole layer sees its complete gradient, equal on every rank.  A split
:class:`~..models.common.Conv2d` convolves the whole input with its slice of
the kernel; a split batch norm normalises its slice of the channels.  A
module of another kind with a split parameter (the spectrally normalised
layers of the Lipschitz U-Net, whose norms span all channels) gathers the
parameter whole in its forward and keeps only its slice's gradient: the
storage and Adam's state are split, the work is not.
(``torch.distributed.nn.functional.all_gather`` is not used: its backward
is an all_to_all, which gloo does not take on CUDA tensors in every torch
release; the two functions here need only all_gather and all_reduce.)

A fresh net is drawn whole from the generator and then sliced, the order of
the JAX package's ``born`` constraint: the TP net starts where the
unsharded one does, and Adam on the slices is Adam on the whole net.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.nn.utils import parametrize

from ..models.common import BatchNorm2d, Conv2d, MeanOnlyBatchNorm
from ..utils.comm import all_gather, all_reduce, group_rank, group_size
from ..utils.device import deterministic_cudnn
from .mesh import axis_group, axis_size

_CHANNEL_LOCAL = (BatchNorm2d, MeanOnlyBatchNorm)  # per-channel: normalise the rank's slice


def _named_tensors(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _split(t: torch.Tensor, n: int) -> bool:
    """The JAX package's rule: a 4-D kernel by its output channels, a
    vector by its one dimension, when ``n`` divides that dimension."""
    return t.ndim in (1, 4) and t.shape[0] % n == 0


def channel_sharding_specs(params, mesh: DeviceMesh, axis: str = "model") -> Dict[str, tuple]:
    """The spec (see :mod:`.sharding`) of every parameter of ``params`` (a
    module or a name -> tensor mapping): output channels of conv kernels and
    per-feature vectors on ``axis`` when its size divides them, else whole."""
    n = axis_size(mesh, axis)
    return {
        name: (axis,) + (None,) * (t.ndim - 1) if _split(t, n) else ()
        for name, t in _named_tensors(params).items()
    }


def channel_sharding_report(params, n_shards: int) -> dict:
    """What :func:`channel_sharding_specs` does with ``params`` over
    ``n_shards`` ranks: the split tensors, the conv kernels left whole
    because ``n_shards`` does not divide their output channels (listed, so
    that replication is never silent), and the count of other whole
    tensors."""
    sharded, indivisible, other = [], [], 0
    for name, t in _named_tensors(params).items():
        if t.ndim == 4:
            (sharded if t.shape[0] % n_shards == 0 else indivisible).append((name, tuple(t.shape)))
        elif t.ndim == 1 and t.shape[0] % n_shards == 0:
            sharded.append((name, tuple(t.shape)))
        else:
            other += 1
    return {
        "n_shards": n_shards,
        "sharded": sharded,
        "indivisible_convs": indivisible,
        "replicated_other": other,
    }


def shard_channelwise(params, mesh: DeviceMesh, axis: str = "model") -> Dict[str, torch.Tensor]:
    """This rank's slice of every parameter, by :func:`channel_sharding_specs`."""
    group = axis_group(mesh, (axis,))
    n, r = group_size(group), group_rank(group)
    out = {}
    for name, t in _named_tensors(params).items():
        width = t.shape[0] // n if _split(t, n) else None
        out[name] = t if width is None else t.narrow(0, r * width, width)
    return out


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; all_reduce of the gradient over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    """All_gather along ``dim`` forward; the rank's own slice of the
    gradient backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        start = group_rank(ctx.group) * ctx.width
        return grad.narrow(ctx.dim, start, ctx.width).contiguous(), None, None


class _Gathered(nn.Module):
    """A parametrization: the whole tensor from this rank's slice (dim 0)."""

    def __init__(self, group):
        super().__init__()
        self.group = group

    def forward(self, local):
        return _GatherFromGroup.apply(local, self.group, 0)


class ChannelParallel(nn.Module):
    """``net`` with its channels split over the ``axis`` ranks of ``mesh``.

    The module keeps the whole net as its template and a copy whose split
    parameters hold this rank's slices (its :meth:`parameters`).
    :meth:`reset_parameters` draws the template from the generator, every
    rank alike, and slices it; :meth:`load_state_dict` loads the template
    from a whole state dict and slices it.  Takes and returns what ``net``
    does, whole on every rank of the axis.

    ``capturable`` is False: the forward and backward run gloo collectives,
    which stage CUDA tensors through the host and cannot be captured in a
    CUDA graph (NCCL could be, but cannot put two ranks on one card), so
    :class:`..solvers.dip.DipFit` steps a fit of this module from the host."""

    capturable = False

    def __init__(self, net: nn.Module, mesh: DeviceMesh, axis: str = "model", strict: bool = False):
        super().__init__()
        self.group = axis_group(mesh, (axis,))
        n = group_size(self.group)
        if strict:
            report = channel_sharding_report(net, n)
            if report["indivisible_convs"]:
                raise ValueError(
                    f"conv kernels with output channels indivisible by {axis}={n} "
                    f"would silently replicate: {report['indivisible_convs']}"
                )
        object.__setattr__(self, "template", net)  # not a submodule: its parameters are not trained
        self.local = copy.deepcopy(net)
        self._pairs = []  # (whole tensor, local tensor, split) for every parameter and buffer
        r = group_rank(self.group)
        # listed first: a parametrization adds modules to the copy's tree
        pairs = list(zip(net.modules(), self.local.modules()))
        for whole_mod, mod in pairs:
            split = [name for name, p in mod.named_parameters(recurse=False) if n > 1 and _split(p, n)]
            for name, p in list(mod.named_parameters(recurse=False)):
                if name in split:
                    width = p.shape[0] // n
                    setattr(mod, name, nn.Parameter(p.detach().narrow(0, r * width, width).clone()))
            if split and isinstance(mod, Conv2d):
                mod.register_forward_pre_hook(self._copy_in)
                mod.register_forward_hook(self._gather_out)
            elif split and isinstance(mod, _CHANNEL_LOCAL):
                mod.register_forward_pre_hook(self._copy_in_own_channels)
                mod.register_forward_hook(self._gather_out)
            else:
                for name in split:
                    parametrize.register_parametrization(mod, name, _Gathered(self.group), unsafe=True)
            for name, p in whole_mod.named_parameters(recurse=False):
                if parametrize.is_parametrized(mod, name):
                    local = mod.parametrizations[name].original
                else:
                    local = getattr(mod, name)
                self._pairs.append((p, local, name in split))
            for name, buf in whole_mod.named_buffers(recurse=False):
                self._pairs.append((buf, getattr(mod, name), False))
        self._rank, self._n = r, n

    def _copy_in(self, module, args):
        return (_CopyToGroup.apply(args[0], self.group),) + tuple(args[1:])

    def _copy_in_own_channels(self, module, args):
        x = _CopyToGroup.apply(args[0], self.group)
        width = x.shape[1] // self._n
        return (x.narrow(1, self._rank * width, width),) + tuple(args[1:])

    def _gather_out(self, module, args, out):
        return _GatherFromGroup.apply(out, self.group, 1)

    @torch.no_grad()
    def _slice_template(self) -> None:
        for whole, local, split in self._pairs:
            if split:
                width = whole.shape[0] // self._n
                whole = whole.narrow(0, self._rank * width, width)
            local.copy_(whole)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw the whole net from ``generator`` (as the unsharded net
        would), then keep this rank's slices."""
        self.template.reset_parameters(generator)
        self._slice_template()

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor], strict: bool = True):
        """Load a whole state dict of ``net``, then keep this rank's slices."""
        result = self.template.load_state_dict(state_dict, strict=strict)
        self._slice_template()
        return result

    def forward(self, *args, **kwargs):
        return self.local(*args, **kwargs)


def make_channel_constraint(
    mesh: DeviceMesh, axis: str = "model", strict: bool = False
) -> Callable[[nn.Module], ChannelParallel]:
    """A ``net -> ChannelParallel(net)`` function: how the sharded engine
    puts each outer step's fresh DIP net on the ``model`` axis.  With
    ``strict=True`` it raises when a conv kernel's output channels are
    indivisible by the axis size, in place of leaving it whole.

    ``constrain.born(state_dict)`` is the rank's slices of a whole state dict:
    a fresh net is drawn whole, then sliced.  The JAX version's ``inputs``
    constraint (the fit's inputs replicated) has no counterpart: the fit's
    inputs and activations are whole on every rank here."""

    def constrain(net: nn.Module) -> ChannelParallel:
        return ChannelParallel(net, mesh, axis, strict=strict)

    constrain.born = lambda state_dict: shard_channelwise(state_dict, mesh, axis)
    return constrain


def make_tp_dip_step(
    model: nn.Module, mesh: DeviceMesh, learning_rate: float = 0.1, axis: str = "model"
) -> Tuple[Callable, Callable]:
    """(init, step) for tensor-parallel DIP training.

    ``init(generator)`` draws ``model`` whole from ``generator``, splits it
    over ``axis`` and returns ``(net, opt)``: the :class:`ChannelParallel`
    net and Adam on its slices.  ``step(net, opt, x, target, mask)`` is one
    Adam update on the masked-MSE DIP loss (the math of ``solvers.dip``) and
    returns ``(loss, out)``, the forward before the update."""

    def init(generator: Optional[torch.Generator] = None):
        net = ChannelParallel(model, mesh, axis)
        net.reset_parameters(generator)
        return net, torch.optim.Adam(net.parameters(), lr=learning_rate)

    @deterministic_cudnn()
    def step(net: ChannelParallel, opt, x, target, mask):
        out = net(x)
        loss = torch.mean((target * mask - out * mask) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), out.detach()

    return init, step
