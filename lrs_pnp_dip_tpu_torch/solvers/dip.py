"""Per-image Deep-Image-Prior training — the DIP prox of the ADMM loop
(counterpart of ``lrs_pnp_dip_tpu/solvers/dip.py``).

Reference semantics (``get_DIP_out``, ``main_LRS_PnP_DIP_pro.py:211-274``):
every outer iteration starts a fresh network, trains it with Adam (lr 0.1)
on the masked MSE ``mean((target*mask - out*mask)^2)`` against the fixed
noisy target, with the current iterate as the network input, and returns
the output at the windowed-variance early stop.

Ordering follows the JAX loop exactly: the output recorded in the window,
and returned as ``last``, is the forward output computed *before* that
iteration's Adam step; the early stop is checked when ``i % show_every ==
0``.  ``torch.optim.Adam``'s defaults equal optax's (b1 0.9, b2 0.999,
eps 1e-8, eps added after the bias-corrected square root).

``compute_dtype='bfloat16'`` follows the JAX fit: a bf16 copy of the
parameters and of the input goes through the whole net, batch-norm
statistics included, the output is cast to f32 before the loss, and the
master parameters and Adam's state stay f32 (the gradients arrive in f32
through the cast).  ``torch.autocast`` would keep batch norm in f32 and
choose types op by op, a different computation, so the cast is explicit.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn

from ..utils.config import DipConfig
from ..utils.device import resolve_device
from .early_stop import init_early_stop, update_early_stop


class DipResult(NamedTuple):
    out: torch.Tensor  # network output at stop (N, H, W, C)
    loss: torch.Tensor  # final masked-MSE loss
    n_iters: int  # iterations actually run
    stopped: bool  # whether early stop fired


def make_dip_fit(model: nn.Module, cfg: DipConfig = DipConfig()):
    """Build ``fit(dip_input, target, mask, init=None, generator=None) -> DipResult``.

    ``dip_input``/``target``: (N, H, W, C); ``mask`` broadcastable to them.
    The net starts from ``init`` (a state dict) when given, else it is
    re-initialised in place from ``generator``: one module serves every
    outer step, each fit starting from fresh parameters and a fresh Adam.
    """
    if cfg.return_mode not in ("last", "window_mean"):
        raise ValueError(
            f"DipConfig.return_mode must be 'last' or 'window_mean', "
            f"got {cfg.return_mode!r}"
        )
    if cfg.es_mode not in ("exact", "incremental"):
        raise ValueError(
            f"DipConfig.es_mode must be 'exact' or 'incremental', got {cfg.es_mode!r}"
        )
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"DipConfig.compute_dtype must be 'float32' or 'bfloat16', "
            f"got {cfg.compute_dtype!r}"
        )
    bf16 = cfg.compute_dtype == "bfloat16"

    def forward(net_input: torch.Tensor) -> torch.Tensor:
        if not bf16:
            return model(net_input)
        cast = {name: p.to(torch.bfloat16) for name, p in model.named_parameters()}
        return torch.func.functional_call(model, cast, (net_input,)).to(torch.float32)

    def fit(
        dip_input: torch.Tensor,
        target: torch.Tensor,
        mask: torch.Tensor,
        init: Optional[Mapping[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> DipResult:
        if init is not None:
            model.load_state_dict(init)
        else:
            model.reset_parameters(generator)
        model.train()
        # a net without parameters (`get_net(..., "identity")`) has nothing to
        # train: its constant output still goes through the early stop
        params = list(model.parameters())
        opt = torch.optim.Adam(params, lr=cfg.learning_rate) if params else None
        es = init_early_stop(
            cfg.buffer_size, target.numel(),
            incremental=cfg.es_mode == "incremental", device=target.device,
        )
        target_masked = target * mask
        net_input = dip_input.to(torch.bfloat16) if bf16 else dip_input
        out = torch.zeros_like(target, dtype=torch.float32)
        loss = torch.tensor(math.inf, dtype=torch.float32, device=target.device)
        i = 0
        while not es.stop and i < cfg.num_iter:
            pred = forward(net_input)
            loss_t = torch.mean((target_masked - pred * mask) ** 2)
            if opt is not None:
                opt.zero_grad(set_to_none=True)
                loss_t.backward()
                opt.step()
            out, loss = pred.detach(), loss_t.detach()
            if i % cfg.show_every == 0:
                update_early_stop(es, out.reshape(-1), i, cfg.patience)
            i += 1
        if cfg.return_mode == "window_mean":
            n_seen = min(es.count, cfg.buffer_size)
            if n_seen > 0:
                out = torch.mean(es.window, dim=0).reshape(target.shape) * (
                    cfg.buffer_size / n_seen
                )
        return DipResult(out=out, loss=loss, n_iters=i, stopped=es.stop)

    return fit


def get_dip_out(
    model: nn.Module,
    generator: Optional[torch.Generator],
    dip_input,
    target,
    mask,
    num_iter: int = 5000,
    learning_rate: float = 0.1,
    show_every: int = 1,
    init: Optional[Mapping[str, torch.Tensor]] = None,
    device="cuda",
) -> DipResult:
    """One-shot convenience mirroring the reference ``get_DIP_out`` call.
    The net starts from ``init`` (a state dict) when given, else from
    ``generator`` (on ``device``).  Runs on ``device``: the card by default,
    which raises when there is none."""
    dev = resolve_device(device)
    cfg = DipConfig(num_iter=num_iter, learning_rate=learning_rate, show_every=show_every)

    def as_tensor(t):
        return torch.as_tensor(t, dtype=torch.float32, device=dev)

    return make_dip_fit(model.to(dev), cfg)(
        as_tensor(dip_input), as_tensor(target), as_tensor(mask), init=init, generator=generator
    )
