"""LRS-PnP-DIP with bfloat16 products, in plain PyTorch: the reference of the
``dip_fast`` configuration (the ``dip_tuned`` balance with bf16 operands).

The same outer step as :mod:`.solver` (its blocks, NLM, step sizes, data
fidelity and dual updates, all float32), with three changes that the
configuration states:

* the sparse prox's masked ISTA takes its two products a iteration on
  operands rounded to bfloat16 and accumulates them in float32: the
  dictionary, the carried coefficients x in ``x D^T`` and the masked
  residual in ``(.) D``, each computed as ``a.bfloat16().float() @
  b.bfloat16().float()`` with TF32 off (a product of two bf16 values is
  exact in float32).  The reconstruction ``x D^T`` after the loop, the NLM,
  alpha and h stay float32;
* the DIP net, skip-128 (:mod:`.skip128`'s layers), runs forward and
  backward in bfloat16: a bf16 copy of the float32 master weights and of the
  input goes through the whole net, batch-norm statistics included; the
  output is cast to float32 before the masked loss, and Adam (lr, betas
  0.9 / 0.999, eps 1e-8) updates the float32 masters;
* the fit returns the mean of its last ``dip_window`` outputs
  (``window_mean``; of all of them where it ran fewer), and stops at the
  windowed-variance early stop with the configuration's patience.

Departures from the program's arithmetic, each a change of float32 rounding
or of summation order only, which the limits of the cell's check cover
because they are set from the program's own readings against this module:

* the early-stop score is the exact ``mean((w - w.mean(0))^2)`` over the
  window at every check, where the program runs the incremental evaluator
  (per-pixel running sums about a shifted origin, resynced every
  ``dip_window`` pushes).  The two scores differ by rounding, so a check
  near the best score can go either way and a fit's length can move by some
  iterations; the fit numbers compare two fits that part within a few
  iterations anyway, by their loss and distance, never by their length;
* the window's mean sums the outputs in the order they came, the program
  its ring buffer in slot order, scaled by ``window / seen``;
* Adam is ``torch.optim.Adam``, the program's a flat-buffer Adam in the
  same operations;
* B1 on the card sums its bf16 products on the tensor cores in another
  order than cuBLAS, which now and then flips the rounding of an operand to
  bf16; cuDNN may pick other bf16 convolution algorithms for the program's
  layers than for these.

The control (``control=True``) rounds every product operand further, from
bfloat16 to ``float8_e4m3fn`` (saturated at its largest finite value, 448):
the ISTA's three operands, and the input and weight of every convolution of
the net.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import skip128
from . import solver as ref

F8_MAX = 448.0  # the largest finite float8_e4m3fn


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """A product operand rounded to bfloat16, held in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """The control's operand: rounded to bfloat16, then to float8_e4m3fn,
    held in float32."""
    b = round_bf16(t).clamp(-F8_MAX, F8_MAX)
    return b.to(torch.float8_e4m3fn).to(torch.float32)


def require_bf16(s: ref.Setup) -> None:
    """Refuse a configuration that this module does not compute."""
    if (s.matmul_dtype, s.dip_dtype) != ("bfloat16", "bfloat16") or s.dip_return not in ("last", "window_mean"):
        raise ValueError(f"the bfloat16 reference computes bf16 products and a bf16 fit, not matmul_dtype "
                         f"{s.matmul_dtype!r}, dip_dtype {s.dip_dtype!r}, dip_return {s.dip_return!r}")


# -- sparse prox -------------------------------------------------------------


def ista(Y: torch.Tensor, M: torch.Tensor, D: torch.Tensor, alpha: torch.Tensor, s: ref.Setup,
         control: bool = False) -> torch.Tensor:
    """Masked PnP-ISTA from x = 0 on the rows of Y (rows, bb*bb) with bf16
    product operands (fp8 with ``control``); returns the coefficients
    (rows, K)."""
    require_bf16(s)
    rnd = round_fp8 if control else round_bf16
    Ym = M * Y
    h = s.h_scale * s.lambda_ista / (2.0 * alpha)
    Dr = rnd(D)
    x = torch.zeros((Y.shape[0], D.shape[1]), device=Y.device)
    for _ in range(s.n_iter):
        pred = rnd(x) @ Dr.T
        g = x + (rnd(Ym - M * pred) @ Dr) / alpha[:, None]
        x = ref.nlm_fast_1d(g, h)
    return x


def sparse_stage(st: ref.State, pr: ref.Problem, s: ref.Setup, control: bool = False) -> torch.Tensor:
    """The sparse prox's reconstructed blocks (..., nB, bb*bb)."""
    blocks = ref.extract(st.X + st.lambda1 / s.mu1, pr.grid)
    rows = blocks.reshape(-1, blocks.shape[-1])
    x = ista(rows, pr.mask_blocks.reshape(rows.shape), pr.D, pr.alpha.reshape(-1), s, control)
    return (x @ pr.D.T).reshape(blocks.shape)


# -- skip-128 in bfloat16 ------------------------------------------------------


def _conv(params: dict, name: str, x: torch.Tensor, q, stride: int = 1) -> torch.Tensor:
    w = params[name + ".weight"]
    if w.shape[-1] == 3:
        x = skip128._reflect1(skip128._reflect1(x, 2), 3)
    return F.conv2d(q(x), q(w), params[name + ".bias"], stride=stride)


def _scale(params: dict, i: int, x: torch.Tensor, q) -> torch.Tensor:
    """:func:`.skip128._scale` with each convolution's operands through ``q``."""
    p = "_SkipScale_0." * (i + 1)
    bn, act = skip128.bn, skip128.act
    d = act(bn(params, p + "BatchNorm2d_0", _conv(params, p + "Conv2d_0", x, q, stride=2)))
    d = act(bn(params, p + "BatchNorm2d_1", _conv(params, p + "Conv2d_1", d, q)))
    if i < skip128.N_SCALES - 1:
        d = _scale(params, i + 1, d, q)
    d = skip128.up2(d)
    sk = act(bn(params, p + "BatchNorm2d_2", _conv(params, p + "Conv2d_2", x, q)))
    h, w = min(sk.shape[2], d.shape[2]), min(sk.shape[3], d.shape[3])
    y = bn(params, p + "BatchNorm2d_3", torch.cat([skip128.crop_to(sk, h, w), skip128.crop_to(d, h, w)], dim=1))
    y = act(bn(params, p + "BatchNorm2d_4", _conv(params, p + "Conv2d_3", y, q)))
    return act(bn(params, p + "BatchNorm2d_5", _conv(params, p + "Conv2d_4", y, q)))


def forward(params: dict, x: torch.Tensor, control: bool = False) -> torch.Tensor:
    """skip-128 on an NCHW float32 input from float32 weights, computed in
    bfloat16 (the operands of every convolution further rounded to fp8 with
    ``control``); returns the output in float32."""
    if control:
        def q(t):
            return round_fp8(t).to(torch.bfloat16)
    else:
        def q(t):
            return t
    cast = {k: v.to(torch.bfloat16) for k, v in params.items()}
    y = _scale(cast, 0, x.to(torch.bfloat16), q)
    return torch.sigmoid(_conv(cast, "Conv2d_0", y, q)).to(torch.float32)


# -- the fit, one step ---------------------------------------------------------


def dip_fit(params0: dict, z: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, s: ref.Setup,
            n_iters: Optional[int] = None, control: bool = False) -> ref.Fit:
    """A fresh skip-128 fit in bfloat16 (:func:`.solver.dip_fit`'s loop and
    early stop).  Each iteration's output (computed before its Adam step)
    enters a window of the last ``dip_window``; the fit returns the mean of
    that window (``window_mean``) or the last output.  ``n_iters`` runs
    exactly that many iterations, without the early stop."""
    require_bf16(s)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    opt = torch.optim.Adam(list(params.values()), lr=s.dip_lr, betas=(0.9, 0.999), eps=1e-8)
    x, m = z[None], mask[None, None]
    tm = target[None] * m
    window, best, wait, out, n = [], math.inf, 0, None, 0
    limit = s.dip_num_iter if n_iters is None else n_iters
    while n < limit:
        pred = forward(params, x, control)
        loss = torch.mean((tm - pred * m) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        out = pred.detach()[0]
        n += 1
        window.append(out.reshape(-1))
        if len(window) > s.dip_window:
            window.pop(0)
        if n_iters is None and len(window) == s.dip_window:
            w = torch.stack(window)
            var = float(torch.mean((w - w.mean(dim=0)) ** 2))
            if var < best:
                best, wait = var, 0
            else:
                wait += 1
            if wait >= s.dip_patience:
                break
    if s.dip_return == "window_mean":
        out = torch.stack(window).mean(dim=0).reshape(out.shape)
    return ref.Fit(out, n)


def dip_prox(st: ref.State, pr: ref.Problem, s: ref.Setup, dip_init: dict, dip_iters: Optional[int] = None,
             control: bool = False) -> ref.Fit:
    """:func:`.solver.dip_prox` with the bf16 fit: ``out`` is (P, B)."""
    h, w, b = pr.shape
    Z = st.X + st.lambda2 / s.mu2
    fit = dip_fit(dip_init, Z.reshape(h, w, b).permute(2, 0, 1), pr.Y.reshape(h, w, b).permute(2, 0, 1),
                  pr.mask[:, 0].reshape(h, w), s, n_iters=dip_iters, control=control)
    return ref.Fit(fit.out.permute(1, 2, 0).reshape(h * w, b), fit.n_iters)


def step(st: ref.State, pr: ref.Problem, s: ref.Setup, dip_init: Optional[dict] = None,
         dip_iters: Optional[int] = None, U: Optional[torch.Tensor] = None, control: bool = False) -> ref.StepOut:
    """One outer step of ``dip`` from ``st`` (one problem), as
    :func:`.solver.step`: ``U`` given takes the place of the fit's output."""
    if s.variant != "dip":
        raise ValueError(f"the bfloat16 reference runs the skip-128 variant 'dip', not {s.variant!r}")
    phi = sparse_stage(st, pr, s, control)
    n = 0
    if U is None:
        U, n = dip_prox(st, pr, s, dip_init, dip_iters, control)
    return ref.StepOut(ref.finish(st, pr, phi, U, s), phi, U, n)
