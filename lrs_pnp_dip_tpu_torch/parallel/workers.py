"""Rank-side cases for :func:`.launch.spawn`: each builds its mesh, runs one
sharded path on every rank and returns host results, which the caller holds
to an unsharded run.  The tests and ``chip_smoke.py`` run them, several per
spawn through :func:`run_cases`, so that a child process imports only this
package.

Every case counts what it launched on this rank: kernel B1's launches and
the bytes the collectives brought (``utils.comm.TRAFFIC``).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.ista_cuda import ISTA_KERNEL
from ..utils.comm import TRAFFIC
from .mesh import make_mesh, mesh_device


def _net(net_spec):
    """A net from ``(name in ..models, kwargs)`` (a net does not pickle: its
    activations are closures), or None."""
    from .. import models

    return None if net_spec is None else getattr(models, net_spec[0])(**net_spec[1])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counted(device, fn):
    """(fn's result, B1 launches, nB of the last launch, bytes moved, seconds)."""
    _sync(device)
    ISTA_KERNEL.reset_counts()
    TRAFFIC.reset()
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    seconds = time.perf_counter() - t0
    plan = ISTA_KERNEL.last_plan
    return out, ISTA_KERNEL.launches, None if plan is None else plan.nB, TRAFFIC.bytes, seconds


def svt_case(device: str, axis_sizes: dict, X: np.ndarray, tau: float) -> tuple:
    """The SVT of X (2-D when the mesh has ``band``) through the drop-in,
    and through the rank's piece (``host_to_global``, the ``distributed_*``
    function, ``fully_replicate``)."""
    from .collectives import distributed_svt, distributed_svt_2d, make_distributed_svt, make_distributed_svt_2d
    from .distributed import fully_replicate, host_to_global

    mesh = make_mesh(axis_sizes, device)
    two_d = "band" in axis_sizes
    drop_in = (make_distributed_svt_2d if two_d else make_distributed_svt)(mesh)
    whole = drop_in(torch.as_tensor(X, device=mesh_device(mesh)), tau).cpu().numpy()
    spec = ("patch", "band" if two_d else None)
    piece = host_to_global(X, spec, mesh)
    piece = distributed_svt_2d(piece, tau, mesh) if two_d else distributed_svt(piece, tau, mesh)
    return whole, fully_replicate(piece, spec, mesh)


def prox_case(device: str, axis_sizes: dict, blocks, mask, D, cfg, alpha=None, forced_plan=None) -> dict:
    """The sharded sparse prox (2-D when the mesh has ``band``): its whole
    output and what this rank launched; with ``forced_plan`` (an
    ``IstaPlan`` of the whole launch) B1 takes that tiling for all the rows,
    each rank its share of it."""
    from .collectives import make_sharded_sparse_prox, make_sharded_sparse_prox_2d

    mesh = make_mesh(axis_sizes, device)
    dev = mesh_device(mesh)
    make = make_sharded_sparse_prox_2d if "band" in axis_sizes else make_sharded_sparse_prox
    prox = make(mesh, cfg)
    args = [torch.as_tensor(a, device=dev) for a in (blocks, mask, D)]
    a = None if alpha is None else torch.as_tensor(alpha, device=dev)
    with ISTA_KERNEL.forcing(*(() if forced_plan is None else (forced_plan,))):
        out, launches, nB, moved, seconds = _counted(dev, lambda: prox(*args, alpha=a))
    return dict(out=out.cpu().numpy(), launches=launches, nB=nB, bytes=moved, seconds=seconds)


def solver_case(
    device: str,
    axis_sizes: dict,
    samples,
    dictionary: np.ndarray,
    config,
    n_steps: int,
    net_spec: Optional[tuple] = None,
    dip_inits: Optional[Sequence[dict]] = None,
    host_stepped: bool = False,
) -> dict:
    """``n_steps`` of :class:`.engine.ShardedSolver`: the whole final X (all
    lanes), and per step the metrics, the whole phi_scatter, the DIP
    iterations and loss, the reads of the stop flag in this rank's last DIP
    fit of the step (0 where the fit ran on another rank), B1's launches and
    last nB on this rank, the bytes moved and the wall seconds; the rank's
    device and TF32 flags.  ``net_spec`` names the DIP net (see :func:`_net`);
    ``dip_inits[itr]`` is the state dict each step's DIP fit starts from,
    when given; ``host_stepped`` steps the DIP fits from the host
    (``OuterStages.fit_chunk`` None) in place of replaying them."""
    from .engine import ShardedSolver

    mesh = make_mesh(axis_sizes, device)
    dev = mesh_device(mesh)
    dip_init = None if dip_inits is None else (lambda itr: dip_inits[itr])
    solver = ShardedSolver(
        samples, dictionary, config, mesh, net=_net(net_spec), device=device, dip_init=dip_init
    )
    if host_stepped:
        solver.stages.fit_chunk = None
    fit = getattr(solver.stages.dip_fit, "fit", solver.stages.dip_fit)  # the DipFit behind a fit on one rank
    state = solver.init_state()
    steps = []
    for _ in range(n_steps):
        if fit is not None:
            fit.flag_reads = 0
        (state, aux), launches, nB, moved, seconds = _counted(dev, lambda: solver.step(state))
        steps.append(dict(
            mpsnr=solver._lanes_metric(aux.mpsnr), ssim=solver._lanes_metric(aux.ssim),
            phi_scatter=solver.gather(aux.phi_scatter, solver._group_spec).cpu().numpy(),
            dip_iters=aux.dip_iters, dip_loss=aux.dip_loss.detach().cpu().numpy(),
            fit_reads=None if fit is None else fit.flag_reads,
            launches=launches, nB=nB, bytes=moved, seconds=seconds,
        ))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    return dict(X=solver.gather(state.X).cpu().numpy(), steps=steps, device=str(dev), tf32=tf32)


def tp_case(
    device: str, axis_sizes: dict, net_spec: tuple, x, target, mask, seed: int, lr: float, n_steps: int,
    cudnn_benchmark: bool = False,
) -> dict:
    """Channel TP of the net ``net_spec`` over ``model`` against it unsharded on
    this rank: the first step's gradients (each split tensor as this rank's
    slice of the TP, the unsharded f32 and the unsharded f64 gradient: the
    last shows the f32 ones' rounding error), then ``n_steps`` Adam steps of
    each (losses, last output); also the specs, the report, and the error of
    ``strict=True`` on a kernel of 7 output channels.  ``cudnn_benchmark``
    lets cuDNN time its algorithms for each shape in place of choosing them
    by heuristics, for this case only."""
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = cudnn_benchmark
    try:
        return _tp_case(device, axis_sizes, net_spec, x, target, mask, seed, lr, n_steps)
    finally:
        torch.backends.cudnn.benchmark = benchmark


def _tp_case(device, axis_sizes, net_spec, x, target, mask, seed, lr, n_steps) -> dict:
    import copy

    from .tensor import (
        ChannelParallel, channel_sharding_report, channel_sharding_specs, make_channel_constraint, make_tp_dip_step,
    )

    mesh = make_mesh(axis_sizes, device)
    dev = mesh_device(mesh)
    x, target, mask = (torch.as_tensor(a, device=dev) for a in (x, target, mask))
    net = _net(net_spec).to(dev)
    ref = copy.deepcopy(net)
    ref.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    ref64 = copy.deepcopy(ref)
    for p in ref64.parameters():  # the buffers keep their types (the U-Net's power iteration runs in f32)
        p.data = p.data.double()
    ref_opt = torch.optim.Adam(ref.parameters(), lr=lr)
    init, step = make_tp_dip_step(net, mesh, learning_rate=lr)
    tp, opt = init(torch.Generator(device=dev).manual_seed(seed))

    def loss_of(model, dtype=torch.float32):
        xd, td, md = (a.to(dtype) for a in (x, target, mask))
        return torch.mean((td * md - model(xd) * md) ** 2)

    loss_of(ref).backward()
    loss_of(ref64, torch.float64).backward()
    loss_of(tp).backward()
    names = {id(p): name for name, p in tp.template.named_parameters()}
    ref_params, ref64_params = dict(ref.named_parameters()), dict(ref64.named_parameters())
    grads = {}
    for whole, local, split in tp._pairs:
        if id(whole) not in names:
            continue  # a buffer
        name = names[id(whole)]
        g_ref, g64 = ref_params[name].grad, ref64_params[name].grad
        if split:
            width = whole.shape[0] // tp._n
            g_ref, g64 = (g.narrow(0, tp._rank * width, width) for g in (g_ref, g64))
        grads[name] = (local.grad.cpu().numpy(), g_ref.cpu().numpy(), split, g64.cpu().numpy())
    ref_opt.zero_grad(set_to_none=True)
    ref_losses, tp_losses = [], []
    for _ in range(n_steps):
        out_ref = ref(x)
        loss = torch.mean((target * mask - out_ref * mask) ** 2)
        ref_opt.zero_grad(set_to_none=True)
        loss.backward()
        ref_opt.step()
        ref_losses.append(float(loss.detach()))
        loss_tp, out_tp = step(tp, opt, x, target, mask)
        tp_losses.append(float(loss_tp))
    try:
        ChannelParallel(torch.nn.Conv2d(5, 7, 3), mesh, strict=True)
        strict_error = None
    except ValueError as e:
        strict_error = str(e)
    born = make_channel_constraint(mesh).born(net.state_dict())
    return dict(
        born={name: tuple(t.shape) for name, t in born.items()},
        grads=grads, ref_losses=ref_losses, tp_losses=tp_losses,
        out_ref=out_ref.detach().cpu().numpy(), out_tp=out_tp.cpu().numpy(),
        specs=channel_sharding_specs(net, mesh), report=channel_sharding_report(net, tp._n),
        strict_error=strict_error,
    )


def dryrun_case(device: str) -> dict:
    """:func:`.distributed.multiprocess_dryrun`'s step: the sharded and the
    local X."""
    from .distributed import dryrun_step

    X, X_local, mesh, mpsnr = dryrun_step(device)
    return dict(X=X, X_local=X_local, mpsnr=mpsnr)


def run_cases(device: str, cases: Sequence[tuple]) -> list:
    """Run ``(case_name, kwargs)`` pairs of this module in order on every
    rank; returns their results."""
    return [globals()[name](device, **kwargs) for name, kwargs in cases]
