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
0``.

One iteration (:meth:`DipFit._iteration`) is forward, masked MSE, backward,
the Adam update, the early-stop push and ``i += 1``, all on tensors that
keep their storage from fit to fit, every update masked by ``active = ~stop
& (i < num_iter)``: an iteration after the stop leaves the parameters,
Adam's moments, ``out``, ``loss`` and the early stop exactly as they were,
as ``while_loop`` under ``vmap`` does for a finished lane.  (Buffers such
as the Lipschitz layers' power-iteration vector still advance; nothing
reads them before the next fit draws them anew.)  So the iteration can be
captured in a CUDA graph once per net and shape and replayed: the fit with
``chunk=k`` replays it ``k`` times between two reads of the stop flag.  That
is how every entry point runs the fit (``OuterStages.fit_chunk`` is
``FIT_CHUNK``): one device program per fit, as the JAX package's jitted
step runs its ``while_loop``.  Without a chunk the host steps the fit and
reads the flag after every iteration, without a graph; the tests and
``chip_smoke.py`` hold the replayed fit to it, and a net whose module
declares ``capturable = False`` (channel TP, whose gloo collectives a graph
cannot hold: :class:`..parallel.tensor.ChannelParallel`) is always stepped
so.  On the CPU both run eagerly and give the same bits.

Adam is written out on one flat f32 buffer that every parameter is a view
of, with its moments beside it, in ``torch.optim.Adam``'s operations and
order (its defaults are optax's: b1 0.9, b2 0.999, eps 1e-8 added after the
bias-corrected square root); the bias corrections of each step come from a
table on the device indexed by ``i``.  On the CPU it gives
``torch.optim.Adam``'s bits (``tests/test_torch_scanned.py``).  The
parameters are re-drawn in place per fit (``reset_parameters`` /
``load_state_dict``) and the moments zeroed in place, so a graph keeps
seeing them.

``compute_dtype='bfloat16'`` follows the JAX fit: a bf16 copy of the
parameters and of the input goes through the whole net, batch-norm
statistics included, the output is cast to f32 before the loss, and the
master parameters and Adam's state stay f32 (the gradients arrive in f32
through the cast).  ``torch.autocast`` would keep batch norm in f32 and
choose types op by op, a different computation, so the cast is explicit.
"""

from __future__ import annotations

import math
import weakref
from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn

from ..utils.config import DipConfig
from ..utils.device import deterministic_cudnn, resolve_device
from ..utils.profiling import annotate
from .early_stop import init_early_stop, reset_early_stop, update_early_stop
from .graphs import Captured

# DIP iterations replayed between two reads of the stop flag in the
# device-resident fit.  A read waits for the device and leaves it idle until
# the host has launched the next chunk; the iterations replayed after the
# stop are wasted, (chunk - 1) / 2 on average.  On an H100 (chip_smoke.py
# phase 9, skip-128) a read per iteration cost about 4% of a replayed
# iteration against chunks of 8, which wasted 4 of a fit's 150 to 350
# iterations (1 to 3%); chunks of 32 gained another 1% per iteration and
# wasted 14.
FIT_CHUNK = 8

_ALIGN = 128  # elements: each parameter's slice of the flat buffer starts on 512 B
_BETA1, _BETA2, _EPS = 0.9, 0.999, 1e-8


class DipResult(NamedTuple):
    out: torch.Tensor  # network output at stop (N, H, W, C)
    loss: torch.Tensor  # final masked-MSE loss
    n_iters: int  # iterations actually run
    stopped: bool  # whether early stop fired


class _FitTensors:
    """The tensors of one fit shape on one device: a captured iteration
    reads and writes these, so they keep their storage from fit to fit."""

    def __init__(self, key, cfg: DipConfig, dip_input, target, mask, bf16: bool):
        dev = target.device
        self.key = key
        self.input = torch.zeros(dip_input.shape, dtype=torch.bfloat16 if bf16 else torch.float32, device=dev)
        self.target_masked = torch.zeros(target.shape, dtype=torch.float32, device=dev)
        self.mask = torch.zeros(mask.shape, dtype=torch.float32, device=dev)
        self.out = torch.zeros(target.shape, dtype=torch.float32, device=dev)
        self.loss = torch.full((), math.inf, dtype=torch.float32, device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        self.status = torch.zeros(3, dtype=torch.int64, device=dev)  # i, stop, count
        self.es = init_early_stop(
            cfg.buffer_size, target.numel(), incremental=cfg.es_mode == "incremental", device=dev
        )

    def restart(self) -> None:
        reset_early_stop(self.es)
        self.i.zero_()
        self.status.zero_()
        self.out.zero_()
        self.loss.fill_(math.inf)


class DipFit:
    """``fit(dip_input, target, mask, init=None, generator=None, chunk=None)
    -> DipResult``.

    ``dip_input``/``target``: (N, H, W, C); ``mask`` broadcastable to them.
    The net starts from ``init`` (a state dict) when given, else it is
    re-initialised in place from ``generator``: one module serves every
    outer step, each fit starting from fresh parameters and a fresh Adam.
    ``chunk=k`` is the device-resident fit (a captured graph on the card,
    replayed ``k`` times per read of the stop flag), what the solvers run;
    ``chunk=None`` steps the fit from the host, and so does every chunk when
    the net's module says ``capturable = False``, which the fit reads before
    it starts.  ``flag_reads`` is the number of reads of the stop flag in
    the latest fit.  The first call flattens the net's
    parameters into one buffer (each stays a parameter of the net, now a
    view of it).  Every call runs with cuDNN's deterministic algorithms
    (:func:`~..utils.device.deterministic_cudnn`), and the nets' padding and
    upsampling have fixed-order backwards: two fits from one init give equal
    bits on the card, graphed or eager."""

    takes_chunk = True  # OuterStages passes it FIT_CHUNK

    def __init__(self, model: nn.Module, cfg: DipConfig = DipConfig()):
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
        self.model = model
        self.cfg = cfg
        self.bf16 = cfg.compute_dtype == "bfloat16"
        # a net without parameters (`get_net(..., "identity")`) has nothing to
        # train: its constant output still goes through the early stop
        self.params = list(model.parameters())
        self._flat = None  # (params, moment 1, moment 2, gradients) buffers
        self._tensors: Optional[_FitTensors] = None
        self._graph: Optional[Captured] = None  # the captured iteration on self._tensors
        self.flag_reads = 0

    # -- the flat parameter buffer and Adam ---------------------------------

    def _flatten(self, device: torch.device) -> None:
        """Make every parameter a view of one flat buffer (again, if
        something gave a parameter new storage since)."""
        if self._flat is not None and all(
            p.data_ptr() == v.data_ptr() for p, v in zip(self.params, self._views)
        ):
            return
        offsets, n = [], 0
        for p in self.params:
            offsets.append(n)
            n += -(-p.numel() // _ALIGN) * _ALIGN
        p_flat, m, v, g = (torch.zeros(n, dtype=torch.float32, device=device) for _ in range(4))
        self._views = []
        for p, o in zip(self.params, offsets):
            view = p_flat[o : o + p.numel()].view_as(p)
            view.copy_(p.detach())
            p.data = view
            self._views.append(view)
        self._grads = [g[o : o + p.numel()].view_as(p) for p, o in zip(self.params, offsets)]
        for p, grad in zip(self.params, self._grads):
            p.grad = grad  # each parameter shows its latest gradient, as after an optimizer step
        self._flat = (p_flat, m, v, g)
        steps = torch.arange(1, self.cfg.num_iter + 1, dtype=torch.float64)
        # torch.optim.Adam's scalars of step t, in float64 as it computes them
        self._neg_step_size = (-(self.cfg.learning_rate / (1 - _BETA1**steps))).float().to(device)
        self._bc2_sqrt = torch.sqrt(1 - _BETA2**steps).float().to(device)
        self._graph = None

    def _adam(self, grads, active: torch.Tensor, i: torch.Tensor) -> None:
        """One Adam step of every parameter at step ``i + 1``, masked by ``active``."""
        p, m, v, g = self._flat
        torch._foreach_copy_(self._grads, list(grads))
        t = torch.clamp(i, max=self.cfg.num_iter - 1).reshape(1)
        m_new = m.lerp(g, 1 - _BETA1)
        v_new = v.mul(_BETA2).addcmul_(g, g, value=1 - _BETA2)
        denom = (v_new.sqrt() / self._bc2_sqrt.index_select(0, t)).add_(_EPS)
        p_new = p + self._neg_step_size.index_select(0, t) * m_new / denom
        for old, new in ((p, p_new), (m, m_new), (v, v_new)):
            old.copy_(torch.where(active, new, old))

    # -- one iteration ------------------------------------------------------

    def _forward(self, net_input: torch.Tensor) -> torch.Tensor:
        if not self.bf16:
            return self.model(net_input)
        cast = {name: p.to(torch.bfloat16) for name, p in self.model.named_parameters()}
        return torch.func.functional_call(self.model, cast, (net_input,)).to(torch.float32)

    def _iteration(self, ft: _FitTensors) -> None:
        cfg = self.cfg
        active = ~ft.es.stop & (ft.i < cfg.num_iter)
        pred = self._forward(ft.input)
        loss = torch.mean((ft.target_masked - pred * ft.mask) ** 2)
        if self.params:
            # a parameter the loss does not reach gets a zero gradient,
            # which leaves it and its moments where they are
            grads = torch.autograd.grad(loss, self.params, allow_unused=True, materialize_grads=True)
            with torch.no_grad():
                self._adam(grads, active, ft.i)
        with torch.no_grad():
            ft.out.copy_(torch.where(active, pred.detach(), ft.out))
            ft.loss.copy_(torch.where(active, loss.detach(), ft.loss))
            check = active & (torch.remainder(ft.i, cfg.show_every) == 0)
            update_early_stop(ft.es, ft.out.reshape(-1), ft.i, cfg.patience, enabled=check)
            ft.i.add_(active.to(torch.int64))
            ft.status.copy_(torch.stack([ft.i, ft.es.stop.to(torch.int64), ft.es.count]))

    # -- a fit --------------------------------------------------------------

    def _start(self, ft: _FitTensors, init, generator) -> None:
        if init is not None:
            self.model.load_state_dict(init)
        else:
            self.model.reset_parameters(generator)
        if self._flat is not None:
            self._flat[1].zero_()
            self._flat[2].zero_()
        ft.restart()

    @deterministic_cudnn()
    def __call__(
        self,
        dip_input: torch.Tensor,
        target: torch.Tensor,
        mask: torch.Tensor,
        init: Optional[Mapping[str, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        chunk: Optional[int] = None,
    ) -> DipResult:
        cfg = self.cfg
        if chunk is not None and chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if not getattr(self.model, "capturable", True):
            chunk = None
        if self.params:
            self._flatten(target.device)
        ft = self._tensors
        key = (target.device, tuple(dip_input.shape), tuple(target.shape), tuple(mask.shape))
        if ft is None or ft.key != key:
            ft = self._tensors = _FitTensors(key, cfg, dip_input, target, mask, self.bf16)
            self._graph = None
        self.model.train()
        with annotate("dip.fit"):
            ft.input.copy_(dip_input)
            ft.target_masked.copy_(target * mask)
            ft.mask.copy_(mask)
            self._start(ft, init, generator)
            if chunk is not None and self._graph is None:
                # the graph holds the fit weakly: a fit dropped by its solver
                # is freed, its graph's memory pool with it, without waiting
                # for the garbage collector
                me = weakref.proxy(self)
                self._graph = Captured(lambda: me._iteration(ft), target.device)
            i = stop = count = reads = 0
            if cfg.num_iter > 0:
                step = (lambda: self._iteration(ft)) if chunk is None else self._graph
                while not stop and i < cfg.num_iter:
                    for _ in range(chunk or 1):
                        step()
                    with annotate("dip.flag_read"):
                        i, stop, count = ft.status.tolist()
                    reads += 1
            self.flag_reads = reads
            out = ft.out.clone()
            if cfg.return_mode == "window_mean":
                n_seen = min(count, cfg.buffer_size)
                if n_seen > 0:
                    out = torch.mean(ft.es.window, dim=0).reshape(target.shape) * (
                        cfg.buffer_size / n_seen
                    )
            return DipResult(out=out, loss=ft.loss.clone(), n_iters=i, stopped=bool(stop))


def make_dip_fit(model: nn.Module, cfg: DipConfig = DipConfig()) -> DipFit:
    """Build the fit of ``model`` under ``cfg``: a :class:`DipFit`."""
    return DipFit(model, cfg)


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
