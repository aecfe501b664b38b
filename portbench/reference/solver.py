"""One outer step of LRS-PnP and LRS-PnP-DIP, and whole solves, in plain
PyTorch: the benchmark's reference.

Written from the reference code's semantics (``main_LRS_PnP_DIP_pro.py``
and ``main_LRS_PnP.py`` in shuoli0708/LRS-PnP-DIP) and nothing of the
program.  Per outer step, on the matricized image (P pixels x B bands):

  1. sparse prox: the blocks of X + lambda1/mu1 (bb x bb, pixel stride bb,
     band starts by the reference's append rule), masked PnP-ISTA from x = 0
     for ``n_iter`` iterations,
         g = x + D^T (m * (y - D x)) / alpha,   x = NLM(g, h),
     h = h_scale * lambda / (2 alpha), and Phi = x D^T;
  2. low-rank prox of Z = X + lambda2/mu2: singular-value soft thresholding
     at 1/mu2 (``lrs_pnp``), or a fresh DIP fit (``dip``): skip-128 from
     the given initial weights with Z as input, Adam on the masked MSE
     against the noisy cube, the output at the windowed-variance early stop;
  3. X = (gamma Y + mu1 IMout + mu2 U - lambda1_sum - lambda2) /
         (gamma mask + mu1 Weight + mu2);
  4. lambda1 += mu1 (X - IMout), lambda2 += mu2 (X - U).

Every tensor is float32.  The precision of the products is the caller's:
the benchmark runs this with TF32 off, and the control with TF32 on.  A
configuration in bfloat16, or whose DIP fit returns its window's mean, is
:mod:`.bf16`'s: :func:`ista`, :func:`dip_fit`, :func:`step`, :func:`solve`
and :func:`solve_scene` refuse its :class:`Setup`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import skip128


@dataclasses.dataclass(frozen=True)
class Setup:
    """The numbers of one configuration that the reference needs."""

    variant: str  # 'lrs_pnp' | 'dip'
    gamma: float
    mu1: float
    mu2: float
    block_size: int
    stride: int
    lambda_ista: float
    n_iter: int
    alpha_mode: str  # 'trace4' | 'specnorm'
    h_scale: float
    power_iters: int
    dip_num_iter: int = 0
    dip_lr: float = 0.0
    dip_window: int = 0
    dip_patience: int = 0
    matmul_dtype: str = "float32"  # B1's product operands: 'float32' | 'bfloat16'
    dip_dtype: str = "float32"  # the DIP net's forward and backward: 'float32' | 'bfloat16'
    dip_return: str = "last"  # the fit's output: 'last' | 'window_mean'

    @classmethod
    def from_config(cls, cfg: dict) -> "Setup":
        """From a configuration file's ``solver`` object."""
        sp, dp = cfg["sparse"], cfg.get("dip") or {}
        if sp["denoiser"] != "nlm_fast":
            raise ValueError("the reference runs the nlm_fast denoiser only")
        if dp and (dp["show_every"] != 1 or dp["input_mode"] != "iterate"):
            raise ValueError("the reference's DIP fit checks every iteration and takes the iterate as input")
        return cls(
            variant=cfg["variant"], gamma=cfg["gamma"], mu1=cfg["mu1"], mu2=cfg["mu2"],
            block_size=cfg["block_size"], stride=cfg["stride"],
            lambda_ista=sp["lambda_ista"], n_iter=sp["n_iter"], alpha_mode=sp["alpha_mode"],
            h_scale=sp["h_scale"], power_iters=sp["power_iters"],
            dip_num_iter=dp.get("num_iter", 0), dip_lr=dp.get("learning_rate", 0.0),
            dip_window=dp.get("buffer_size", 0), dip_patience=dp.get("patience", 0),
            matmul_dtype=sp["matmul_dtype"], dip_dtype=dp.get("compute_dtype", "float32"),
            dip_return=dp.get("return_mode", "last"),
        )


def require_f32(s: Setup) -> None:
    """Refuse a configuration that this module's float32 arithmetic does not
    compute: bfloat16 products or fit, or a fit that returns its window's
    mean (:mod:`.bf16` computes those)."""
    if (s.matmul_dtype, s.dip_dtype, s.dip_return) != ("float32", "float32", "last"):
        raise ValueError(f"the float32 reference computes float32 products and a fit that returns its "
                         f"last output, not matmul_dtype {s.matmul_dtype!r}, dip_dtype {s.dip_dtype!r}, "
                         f"dip_return {s.dip_return!r}")


# -- blocks ------------------------------------------------------------------


def starts(extent: int, bb: int, stride: int) -> list:
    """Block starts along one axis; the last start is appended when the
    extent is not a multiple of bb (``main_LRS_PnP_DIP_pro.py:123-157``)."""
    s = list(range(0, extent - bb + 1, stride))
    if extent % bb != 0 and s[-1] != extent - bb:
        s.append(extent - bb)
    return s


class Grid(NamedTuple):
    P: int
    B: int
    bb: int
    band_starts: tuple
    n_pix_blocks: int


def grid(P: int, B: int, bb: int, stride: int) -> Grid:
    if stride != bb or P % bb != 0:
        raise ValueError("the reference takes pixel blocks that tile the pixel axis (stride = bb)")
    return Grid(P, B, bb, tuple(starts(B, bb, stride)), P // bb)


def extract(Z: torch.Tensor, g: Grid) -> torch.Tensor:
    """(..., P, B) -> (..., nB, bb*bb): band start slow, pixel start fast;
    within a block the entry of band b and pixel p at b * bb + p."""
    lead, n, bb = Z.shape[:-2], g.n_pix_blocks, g.bb
    out = []
    for y0 in g.band_starts:
        seg = Z[..., y0 : y0 + bb].reshape(*lead, n, bb, bb)  # [blk, pix, band]
        out.append(seg.transpose(-1, -2).reshape(*lead, n, bb * bb))
    return torch.cat(out, dim=-2)


def scatter(blocks: torch.Tensor, g: Grid) -> torch.Tensor:
    """Sum of the blocks (..., nB, bb*bb) placed back on (..., P, B), the
    adjoint of :func:`extract`."""
    lead, n, bb = blocks.shape[:-2], g.n_pix_blocks, g.bb
    out = torch.zeros((*lead, g.P, g.B), dtype=blocks.dtype, device=blocks.device)
    for k, y0 in enumerate(g.band_starts):
        seg = blocks[..., k * n : (k + 1) * n, :].reshape(*lead, n, bb, bb).transpose(-1, -2)
        out[..., y0 : y0 + bb] += seg.reshape(*lead, g.P, bb)
    return out


# -- sparse prox -------------------------------------------------------------


def nlm_fast_1d(G: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """skimage's fast-mode non-local means (patch 3, distance 3) of each row
    of G (nB, K) taken as a (K, 1) image, each with its own h (nB,).

    On a one-column image every 3x3 patch holds its column three times and
    the 7 columns of the search window see the same rows, so for a row
    offset d (|d| in 1..3) the weight is 7 exp(-3 sum_u (p[r+u] - p[r+d+u])^2
    / (9 h^2)) over u in -1..1, and the centre's weight is 8; the padding is
    a reflection by 5 along K."""
    K = G.shape[1]
    pad = 5
    idx = torch.as_tensor(np.pad(np.arange(K), pad, mode="reflect"), device=G.device)
    p = G[:, idx]  # (nB, K + 10)
    L = K + 2 * pad
    inv = 1.0 / torch.clamp(9.0 * h * h, min=1e-30)[:, None]
    num = 8.0 * p
    den = torch.full_like(p, 8.0)
    for d in (1, 2, 3):
        sq = (p[:, : L - d] - p[:, d:]) ** 2  # sq[j] = (p[j] - p[j + d])^2
        # the rows r = 1 .. L - d - 2 and r + d, whose patches lie inside the padding
        w = 7.0 * torch.exp(-3.0 * (sq[:, :-2] + sq[:, 1:-1] + sq[:, 2:]) * inv)
        num[:, 1 : L - d - 1] += w * p[:, 1 + d : L - 1]
        den[:, 1 : L - d - 1] += w
        num[:, 1 + d : L - 1] += w * p[:, 1 : L - d - 1]
        den[:, 1 + d : L - 1] += w
    return (num / den)[:, pad : pad + K]


def step_sizes(D: torch.Tensor, M: torch.Tensor, s: Setup) -> torch.Tensor:
    """alpha (rows,) of the masks M (rows, bb*bb): 4 sum_r m_r |D_r|^2
    (``trace4``), or the largest eigenvalue of D^T diag(m) D by
    ``power_iters`` power iterations from the uniform unit vector, read as
    the Rayleigh quotient (``specnorm``); clamped at 1e-12."""
    if s.alpha_mode == "trace4":
        alpha = 4.0 * (M @ (D * D).sum(dim=1))
    elif s.alpha_mode == "specnorm":
        K = D.shape[1]
        v = torch.full((M.shape[0], K), 1.0 / math.sqrt(K), device=D.device)
        for _ in range(s.power_iters):
            u = (M * (v @ D.T)) @ D
            v = u / (torch.linalg.norm(u, dim=1, keepdim=True) + 1e-30)
        alpha = (v * ((M * (v @ D.T)) @ D)).sum(dim=1)
    else:
        raise ValueError(s.alpha_mode)
    return torch.clamp(alpha, min=1e-12)


def ista(Y: torch.Tensor, M: torch.Tensor, D: torch.Tensor, alpha: torch.Tensor, s: Setup) -> torch.Tensor:
    """Masked PnP-ISTA from x = 0 on the rows of Y (rows, bb*bb); returns the
    coefficients (rows, K)."""
    require_f32(s)
    Ym = M * Y
    h = s.h_scale * s.lambda_ista / (2.0 * alpha)
    x = torch.zeros((Y.shape[0], D.shape[1]), device=Y.device)
    for _ in range(s.n_iter):
        g = x + ((Ym - M * (x @ D.T)) @ D) / alpha[:, None]
        x = nlm_fast_1d(g, h)
    return x


# -- low-rank prox -----------------------------------------------------------


def svt(Z: torch.Tensor, tau: float) -> torch.Tensor:
    """Singular-value soft thresholding of each Z (..., P, B) (``main_LRS_PnP.py:118-124``)."""
    U, sv, Vh = torch.linalg.svd(Z, full_matrices=False)
    return (U * torch.clamp(sv - tau, min=0.0)[..., None, :]) @ Vh


class Fit(NamedTuple):
    out: torch.Tensor  # (B, H, W), the output of the last iteration run
    n_iters: int


def dip_fit(params0: dict, z: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, s: Setup,
            n_iters: Optional[int] = None) -> Fit:
    """A fresh skip-128 fit (``get_DIP_out``, ``main_LRS_PnP_DIP_pro.py:224-274``).

    ``z``, ``target``: (B, H, W); ``mask``: (H, W).  Each iteration runs the
    net on z, takes the loss mean((target m - out m)^2) and an Adam step (lr
    ``dip_lr``, betas 0.9 / 0.999, eps 1e-8), then pushes that iteration's
    output (computed before the step) into a window of the last
    ``dip_window``; once the window is full its variance
    mean((w - mean(w))^2) is checked, and the fit stops when it has not gone
    below its lowest for ``dip_patience`` checks, or after ``dip_num_iter``
    iterations.  ``n_iters`` runs exactly that many iterations instead."""
    require_f32(s)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    opt = torch.optim.Adam(list(params.values()), lr=s.dip_lr, betas=(0.9, 0.999), eps=1e-8)
    x, m = z[None], mask[None, None]
    tm = target[None] * m
    window, best, wait, out, n = [], math.inf, 0, None, 0
    limit = s.dip_num_iter if n_iters is None else n_iters
    while n < limit:
        pred = skip128.forward(params, x)
        loss = torch.mean((tm - pred * m) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        out = pred.detach()[0]
        n += 1
        if n_iters is not None:
            continue
        window.append(out.reshape(-1))
        if len(window) > s.dip_window:
            window.pop(0)
        if len(window) == s.dip_window:
            w = torch.stack(window)
            var = float(torch.mean((w - w.mean(dim=0)) ** 2))
            if var < best:
                best, wait = var, 0
            else:
                wait += 1
            if wait >= s.dip_patience:
                break
    return Fit(out, n)


# -- one step, a solve -------------------------------------------------------


class Problem(NamedTuple):
    """Problems of one shape, stacked on the leading axes of every field."""

    Y: torch.Tensor  # (..., P, B) observed, missing pixels zero
    mask: torch.Tensor  # (..., P, B)
    mask_blocks: torch.Tensor  # (..., nB, bb*bb): 1 where the observed entry is nonzero
    D: torch.Tensor
    alpha: torch.Tensor  # (..., nB)
    shape: tuple  # (H, W, B)
    grid: Grid


def problem(noisy: np.ndarray, mask_hw: np.ndarray, D: np.ndarray, s: Setup, device) -> Problem:
    """From cubes (..., H, W, B) and their masks (..., H, W)."""
    *lead, h, w, b = noisy.shape
    Y = torch.as_tensor(noisy.reshape(*lead, h * w, b), dtype=torch.float32, device=device)
    mask = torch.as_tensor(mask_hw.reshape(*lead, h * w, 1), dtype=torch.float32, device=device).expand_as(Y)
    g = grid(h * w, b, s.block_size, s.stride)
    mask_blocks = (extract(Y, g) != 0).to(torch.float32)
    Dt = torch.as_tensor(D, dtype=torch.float32, device=device)
    alpha = step_sizes(Dt, mask_blocks.reshape(-1, g.bb * g.bb), s).reshape(mask_blocks.shape[:-1])
    return Problem(Y, mask.contiguous(), mask_blocks, Dt, alpha, (h, w, b), g)


class State(NamedTuple):
    X: torch.Tensor
    lambda1: torch.Tensor
    lambda2: torch.Tensor


def initial_state(pr: Problem) -> State:
    return State(pr.Y.clone(), torch.zeros_like(pr.Y), torch.zeros_like(pr.Y))


class StepOut(NamedTuple):
    state: State
    phi: torch.Tensor  # (..., nB, bb*bb) the sparse prox's blocks
    U: torch.Tensor  # (..., P, B) the low-rank prox
    dip_iters: int


def sparse_stage(st: State, pr: Problem, s: Setup) -> torch.Tensor:
    blocks = extract(st.X + st.lambda1 / s.mu1, pr.grid)
    rows = blocks.reshape(-1, blocks.shape[-1])
    x = ista(rows, pr.mask_blocks.reshape(rows.shape), pr.D, pr.alpha.reshape(-1), s)
    return (x @ pr.D.T).reshape(blocks.shape)


def finish(st: State, pr: Problem, phi: torch.Tensor, U: torch.Tensor, s: Setup) -> State:
    im_out = scatter(phi, pr.grid)
    weight = scatter(torch.ones_like(phi), pr.grid)
    l1_sum = scatter(extract(st.lambda1, pr.grid), pr.grid)
    X = (s.gamma * pr.Y + s.mu1 * im_out + s.mu2 * U - l1_sum - st.lambda2) / (
        s.gamma * pr.mask + s.mu1 * weight + s.mu2)
    return State(X, st.lambda1 + s.mu1 * (X - im_out), st.lambda2 + s.mu2 * (X - U))


def dip_prox(st: State, pr: Problem, s: Setup, dip_init: dict, dip_iters: Optional[int] = None) -> Fit:
    """The low-rank prox of ``dip`` (one problem): a fresh fit from the
    initial weights ``dip_init`` with Z = X + lambda2/mu2 as input and the
    noisy cube as target; ``out`` is (P, B)."""
    h, w, b = pr.shape
    Z = st.X + st.lambda2 / s.mu2
    fit = dip_fit(dip_init, Z.reshape(h, w, b).permute(2, 0, 1), pr.Y.reshape(h, w, b).permute(2, 0, 1),
                  pr.mask[:, 0].reshape(h, w), s, n_iters=dip_iters)
    return Fit(fit.out.permute(1, 2, 0).reshape(h * w, b), fit.n_iters)


def masked_loss(U: torch.Tensor, pr: Problem) -> float:
    """The DIP fit's objective at an output U (P, B): mean((m Y - m U)^2)."""
    return float(torch.mean((pr.mask * (pr.Y - U)) ** 2))


def step(st: State, pr: Problem, s: Setup, dip_init: Optional[dict] = None,
         dip_iters: Optional[int] = None, U: Optional[torch.Tensor] = None) -> StepOut:
    """One outer step from ``st``.  ``dip_init`` is the DIP net's initial
    weights (``dip``, one problem), ``dip_iters`` pins the fit's length;
    ``U`` given takes the place of the low-rank prox's output (``dip``: the
    fit's)."""
    require_f32(s)
    phi = sparse_stage(st, pr, s)
    n = 0
    if U is None and s.variant == "lrs_pnp":
        U = svt(st.X + st.lambda2 / s.mu2, 1.0 / s.mu2)
    elif U is None and s.variant == "dip":
        U, n = dip_prox(st, pr, s, dip_init, dip_iters)
    elif U is None:
        raise ValueError(s.variant)
    return StepOut(finish(st, pr, phi, U, s), phi, U, n)


def solve(noisy: np.ndarray, mask_hw: np.ndarray, D: np.ndarray, s: Setup, n_steps: int, device) -> torch.Tensor:
    """``n_steps`` outer steps of ``lrs_pnp`` from X = Y, of each cube
    (..., H, W, B) alone; returns X as (..., H, W, B)."""
    require_f32(s)
    pr = problem(noisy, mask_hw, D, s, device)
    st = initial_state(pr)
    for _ in range(n_steps):
        st = step(st, pr, s).state
    return st.X.reshape(noisy.shape)


def solve_scene(noisy: np.ndarray, mask_hw: np.ndarray, D: np.ndarray, s: Setup, n_steps: int,
                tile: tuple, device) -> np.ndarray:
    """A scene cut into tiles of ``tile`` pixels (the last row and column of
    tiles pulled in to cover it), each tile solved alone, the recoveries put
    back and averaged where tiles overlap."""
    require_f32(s)
    H, W, _ = noisy.shape
    th, tw = tile
    origins = [(h0, w0) for h0 in starts(H, th, th) for w0 in starts(W, tw, tw)]
    cubes = solve(np.stack([noisy[h0 : h0 + th, w0 : w0 + tw] for h0, w0 in origins]),
                  np.stack([mask_hw[h0 : h0 + th, w0 : w0 + tw] for h0, w0 in origins]),
                  D, s, n_steps, device).double().cpu().numpy()
    out = np.zeros(noisy.shape, np.float64)
    cover = np.zeros((H, W, 1), np.float64)
    for cube, (h0, w0) in zip(cubes, origins):
        out[h0 : h0 + th, w0 : w0 + tw] += cube
        cover[h0 : h0 + th, w0 : w0 + tw] += 1.0
    return (out / cover).astype(np.float32)
