"""Standalone DIP trainer (counterpart of ``lrs_pnp_dip_tpu/solvers/fit.py``;
reference ``include/fit.py:12-141``): a generic DIP fit loop with

  * optimizer choice: ``adam`` (``torch.optim.Adam``, whose defaults and eps
    placement are optax's), ``sgd`` (``torch.optim.SGD`` with momentum 0.9,
    the same trace as ``optax.sgd``) or ``lbfgs`` (below);
  * optional *input* optimization (the noise input is a trainable leaf);
  * additive input-noise regularisation with exponential decay
    (``reg_noise_std`` multiplied by ``reg_noise_decay`` every
    ``reg_noise_decayevery`` steps), drawn from the caller's generator;
  * the staircase exponential learning-rate decay of
    ``optax.exponential_decay(staircase=True)``, stepped once per iteration;
  * loss modes: plain MSE, masked MSE, or MSE after a measurement map
    ``apply_f``;
  * ``find_best``: keep the parameters of the lowest-loss step (the
    reference keeps a net snapshot whenever the loss improves by >= 0.5%).

``lbfgs`` is ``torch.optim.LBFGS`` with one iteration per step, a memory of
10 and a strong-Wolfe line search.  ``optax.lbfgs()`` has the same memory
and conditions but another line search (zoom) and a scaled initial
preconditioner, so the two take other steps on the way to a minimum.

The loop runs from the host, one optimizer step per iteration; the losses,
the best-loss test and the snapshot stay on the device (no host sync).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional

import torch
from torch import nn

from ..utils.device import deterministic_cudnn, resolve_device


@dataclasses.dataclass(frozen=True)
class FitConfig:
    num_iter: int = 5000
    lr: float = 0.01
    optimizer: str = "adam"  # 'adam' | 'sgd' | 'lbfgs'
    opt_input: bool = False
    reg_noise_std: float = 0.0
    reg_noise_decay: float = 0.7
    reg_noise_decayevery: int = 100000
    lr_decay_epoch: int = 0  # 0 = constant lr
    lr_decay_rate: float = 0.65
    find_best: bool = True


class FitResult(NamedTuple):
    out: torch.Tensor  # the net's output at the last step (before its update)
    params: Dict[str, torch.Tensor]  # final parameters, by name
    best_params: Dict[str, torch.Tensor]  # parameters of the best loss, by name
    losses: torch.Tensor  # (num_iter,)
    net_input: torch.Tensor


def find_best_update(loss, best_loss, best_params, eval_params, rel: float = 1.005):
    """Snapshot rule of reference ``include/fit.py:133``: keep the params a
    loss was computed at only when it improves the best by >= (rel-1)
    (``if best_mse > 1.005*loss.data``).  A loss merely close to the best
    must NOT overwrite the snapshot.  Tensors in, new tensors out."""
    improved = loss * rel < best_loss
    best_loss = torch.where(improved, loss, best_loss)
    best_params = {k: torch.where(improved, eval_params[k], b) for k, b in best_params.items()}
    return best_loss, best_params


def _optimizer(cfg: FitConfig, leaves):
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(leaves, lr=cfg.lr)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(leaves, lr=cfg.lr, momentum=0.9)
    elif cfg.optimizer == "lbfgs":
        # the reference offered LBFGS with an Adam warmup; the line search
        # sets the step, so there is no learning rate to decay
        return torch.optim.LBFGS(
            leaves, lr=1.0, max_iter=1, history_size=10, line_search_fn="strong_wolfe"
        ), None
    else:
        raise ValueError(cfg.optimizer)
    sched = None
    if cfg.lr_decay_epoch > 0:
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda i: cfg.lr_decay_rate ** (i // cfg.lr_decay_epoch)
        )
    return opt, sched


@deterministic_cudnn()
def fit(
    model: nn.Module,
    generator: Optional[torch.Generator],
    net_input,
    target,
    mask=None,
    apply_f: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    config: FitConfig = FitConfig(),
    init: Optional[Mapping[str, torch.Tensor]] = None,
    device="cuda",
) -> FitResult:
    """Train a DIP net on one target.  Returns the final and the best params.

    The net starts from ``init`` (a state dict) when given, else it is
    re-initialised in place from ``generator``, which also draws the input
    noise of ``reg_noise_std``; the generator lives on ``device``.  Runs on
    ``device``: the card by default, which raises when there is none, with
    cuDNN's deterministic algorithms (:func:`~..utils.device.deterministic_cudnn`)."""
    cfg = config
    dev = resolve_device(device)
    model = model.to(dev)
    if init is not None:
        model.load_state_dict(init)
    else:
        model.reset_parameters(generator)
    model.train()

    def as_tensor(t):
        return None if t is None else torch.as_tensor(t, dtype=torch.float32, device=dev)

    net_input, target, mask = as_tensor(net_input), as_tensor(target), as_tensor(mask)
    named = dict(model.named_parameters())
    leaves = list(named.values())
    if cfg.opt_input:
        net_input = net_input.detach().clone().requires_grad_(True)
        leaves.append(net_input)
    opt, sched = _optimizer(cfg, leaves)

    def loss_of(out):
        if apply_f is not None:
            out = apply_f(out)
        if mask is not None:
            return torch.mean((out * mask - target * mask) ** 2)
        return torch.mean((out - target) ** 2)

    best_loss = torch.tensor(math.inf, device=dev)
    best = {k: p.detach().clone() for k, p in named.items()}
    losses = []
    out = None
    for i in range(cfg.num_iter):
        inp = net_input
        if cfg.reg_noise_std > 0:
            std = cfg.reg_noise_std * cfg.reg_noise_decay ** (i // cfg.reg_noise_decayevery)
            inp = net_input + std * torch.randn(net_input.shape, generator=generator, device=dev)
        if cfg.optimizer == "lbfgs":
            # the params the loss is computed at, before the line search moves them
            eval_params = {k: p.detach().clone() for k, p in named.items()} if cfg.find_best else None
            first = {}

            def closure():
                opt.zero_grad(set_to_none=True)
                o = model(inp)
                lo = loss_of(o)
                lo.backward()
                first.setdefault("out", o.detach())
                first.setdefault("loss", lo.detach())
                return lo

            opt.step(closure)
            out, loss = first["out"], first["loss"]
        else:
            opt.zero_grad(set_to_none=True)
            o = model(inp)
            lo = loss_of(o)
            lo.backward()
            out, loss = o.detach(), lo.detach()
            eval_params = {k: p.detach() for k, p in named.items()}
        if cfg.find_best:
            # where() copies, so the snapshot survives the in-place step below
            best_loss, best = find_best_update(loss, best_loss, best, eval_params)
        if cfg.optimizer != "lbfgs":
            opt.step()
            if sched is not None:
                sched.step()
        losses.append(loss)
    return FitResult(
        out=out,
        params={k: p.detach().clone() for k, p in named.items()},
        best_params=best,
        losses=torch.stack(losses),
        net_input=net_input.detach(),
    )
