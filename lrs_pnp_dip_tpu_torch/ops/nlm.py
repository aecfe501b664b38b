"""Non-local-means denoisers (counterpart of ``lrs_pnp_dip_tpu/ops/nlm.py``).

  * :func:`nlm2d`, :func:`nlm_column`, :func:`nlm_column_batch`: the
    fast-mode pairwise NLM of skimage (patch 3, distance 3) on 2-D images;
  * :func:`nlm_column_batch_fast`: the same on (K, 1) images collapsed
    exactly to a 1-D filter, the denoiser of the PnP-ISTA loop;
  * :func:`nlm_classic`: the MATLAB twin's classic NLM (``NLmeansfilter.m``),
    and :func:`nlm_classic_column_batch`, its exact collapse on (K, 1)
    images, the denoiser of the `matlab` preset.

Every function takes one image or a batch with a leading axis and a per-image
``h``, where the JAX package vmaps.  Padding follows ``np.pad``: its
'reflect' (edge excluded) and 'symmetric' (edge included) modes, on axes of
any length, including the width-1 axis of a (K, 1) image, which torch's own
reflect pad refuses.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def np_pad_index(n: int, pad: int, mode: str, device) -> torch.Tensor:
    """Source index of every position of an axis of length ``n`` padded by
    ``pad`` on both sides as ``np.pad(mode=mode)`` pads it."""
    i = torch.arange(-pad, n + pad, device=device)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        period = 2 * (n - 1)
        i = torch.remainder(i, period)
        return torch.where(i >= n, period - i, i)
    if mode == "symmetric":
        period = 2 * n
        i = torch.remainder(i, period)
        return torch.where(i >= n, period - 1 - i, i)
    raise ValueError(f"unknown pad mode {mode!r}")


def _pad2d(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Pad the last two axes of (N, m, n) as ``np.pad`` does."""
    rows = np_pad_index(x.shape[-2], pad, mode, x.device)
    cols = np_pad_index(x.shape[-1], pad, mode, x.device)
    return x[:, rows[:, None], cols[None, :]]


def _as_batch(image: torch.Tensor, h):
    """(N, m, n) f32 images, (N or 1, 1, 1) f32 h, and whether the input
    was a single image."""
    single = image.ndim == 2
    x = image.to(torch.float32)
    if single:
        x = x[None]
    h = torch.as_tensor(h, dtype=torch.float32, device=x.device).reshape(-1, 1, 1)
    return x, h, single


def _box_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Sum over the centered (2r+1)^2 window of (N, m, n), rolled around the
    edges (callers read only positions whose windows lie inside)."""
    out = torch.zeros_like(x)
    for u in range(-radius, radius + 1):
        rolled_u = torch.roll(x, -u, dims=1)
        for v in range(-radius, radius + 1):
            out = out + torch.roll(rolled_u, -v, dims=2)
    return out


def nlm2d(
    image: torch.Tensor, h, patch_size: int = 3, patch_distance: int = 3
) -> torch.Tensor:
    """Fast-mode pairwise NLM of an (m, n) image or an (N, m, n) batch;
    ``h`` is a scalar or one per image.

    Reflect pad ``offset + d + 1``; for every half-space shift t the box
    patch distance, the pair weight ``alpha * exp(-dist / (h^2 s^2))`` with
    alpha 0.5 on the t_col = 0 axis (t != 0), each pair adding to both ends
    (the self pair included); the weighted average, cropped back."""
    s, d = patch_size, patch_distance
    offset = s // 2
    pad = offset + d + 1
    x, h, single = _as_batch(image, h)
    m, n = x.shape[1:]
    P = _pad2d(x, pad, "reflect")
    pr, pc = P.shape[1:]
    h2s2 = torch.clamp(h**2 * (s * s), min=1e-30)
    rows = torch.arange(pr, device=x.device)[:, None]
    cols = torch.arange(pc, device=x.device)[None, :]

    result = torch.zeros_like(P)
    weights = torch.zeros_like(P)
    for t_row in range(-d, d + 1):
        for t_col in range(0, d + 1):
            alpha = 0.5 if (t_col == 0 and t_row != 0) else 1.0
            shifted = torch.roll(P, (-t_row, -t_col), (1, 2))
            dist = _box_sum((P - shifted) ** 2, offset)
            w = alpha * torch.exp(-torch.clamp(dist, min=0.0) / h2s2)
            # both the patch window and the partner's stay inside the padding
            row_lo = max(offset, offset - t_row)
            row_hi = pr - max(offset, offset + t_row)
            valid = (rows >= row_lo) & (rows < row_hi) & (cols >= offset) & (cols < pc - offset - t_col)
            w = torch.where(valid, w, 0.0)
            # pair (p, p+t): p gathers w * I[p+t], p+t gathers w * I[p]
            result = result + w * shifted
            weights = weights + w
            back_w = torch.roll(w, (t_row, t_col), (1, 2))
            result = result + back_w * torch.roll(P, (t_row, t_col), (1, 2))
            weights = weights + back_w

    out = (result / torch.clamp(weights, min=1e-30))[:, pad : pad + m, pad : pad + n]
    return out[0] if single else out


def nlm_column(vec: torch.Tensor, h, patch_size: int = 3, patch_distance: int = 3) -> torch.Tensor:
    """NLM of a length-K vector taken as a (K, 1) image."""
    return nlm2d(vec[:, None], h, patch_size, patch_distance)[:, 0]


def nlm_column_batch(G: torch.Tensor, h, patch_size: int = 3, patch_distance: int = 3) -> torch.Tensor:
    """:func:`nlm_column` of every row of G (nB, K) with its own h (nB,)."""
    return nlm2d(G[:, :, None], h, patch_size, patch_distance)[:, :, 0]


def nlm_column_batch_fast(G: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """skimage fast-mode NLM (patch 3, distance 3) on a batch of (K, 1)
    images, collapsed exactly to a 1-D filter along K.

    Reflect pad 5; for delta in {1, 2, 3} the weight at row r is
    ``7 * exp(-3 * sum_{u=-1..1} (p[r+u] - p[r+delta+u])^2 / (9 h^2))``,
    applied forward and backward; the self weight is 8; the output is
    num / den.

    G: (nB, K); h: (nB,) per-block bandwidth.  Returns (nB, K).
    """
    nb, K = G.shape
    pad = 5
    P = F.pad(G.to(torch.float32)[:, None, :], (pad, pad), mode="reflect")[:, 0]
    h2s2 = torch.clamp((h.to(torch.float32) ** 2) * 9.0, min=1e-30)[:, None]

    num = 8.0 * P
    den = torch.full_like(P, 8.0)
    L = P.shape[1]
    for delta in (1, 2, 3):
        # sq[:, r] = (P[r] - P[r+delta])^2, r in [0, L-delta)
        sq = (P[:, : L - delta] - P[:, delta:]) ** 2
        # dist[:, j] = 3 * (sq[j] + sq[j+1] + sq[j+2]): the window about row j+1
        dist = 3.0 * (sq[:, :-2] + sq[:, 1:-1] + sq[:, 2:])
        w = 7.0 * torch.exp(-dist / h2s2)  # w[:, j] is the weight at row j+1
        # forward: out[r] += w_delta(r) * P[r+delta]
        num[:, 1 : L - delta - 1] += w * P[:, 1 + delta : L - 1]
        den[:, 1 : L - delta - 1] += w
        # backward: out[r+delta] += w_delta(r) * P[r]
        num[:, 1 + delta : L - 1] += w * P[:, 1 : L - delta - 1]
        den[:, 1 + delta : L - 1] += w
    return (num / den)[:, pad : pad + K]


def _ring_kernel(f: int) -> np.ndarray:
    """The MATLAB twin's patch kernel (``NLmeansfilter.m make_kernel``):
    nested box rings, value 1/(2d+1)^2 per ring d=1..f, divided by f, then
    normalised to sum 1."""
    k = np.zeros((2 * f + 1, 2 * f + 1))
    for d in range(1, f + 1):
        k[f - d : f + d + 1, f - d : f + d + 1] += 1.0 / (2 * d + 1) ** 2
    k /= f
    return (k / k.sum()).astype(np.float32)


def nlm_classic(
    image: torch.Tensor, h, search_radius: int = 3, patch_radius: int = 3
) -> torch.Tensor:
    """Classic Buades NLM with the MATLAB twin's semantics
    (``NLmeansfilter.m:32-78``) on an (m, n) image or an (N, m, n) batch;
    ``h`` is a scalar or one per image:

      * symmetric (edge-including) padding of width ``patch_radius``;
      * ring-weighted patch distance, w = exp(-d / h^2), h^2 clamped at 1e-30;
      * neighbours only from inside the image (the search window is clamped
        to the image, not to the padding);
      * the self pixel re-added with the largest neighbour weight (``wmax``);
      * an all-zero weight sum returns the input pixel.
    """
    t, f = search_radius, patch_radius
    x, h, single = _as_batch(image, h)
    m, n = x.shape[1:]
    P = _pad2d(x, f, "symmetric")
    kernel = torch.from_numpy(_ring_kernel(f)).to(x.device)[None, None]
    h2 = torch.clamp(h**2, min=1e-30)
    rows = torch.arange(m, device=x.device)[:, None]
    cols = torch.arange(n, device=x.device)[None, :]

    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    wmax = torch.zeros_like(x)
    for dr in range(-t, t + 1):
        for ds in range(-t, t + 1):
            if dr == 0 and ds == 0:
                continue
            valid = (rows + dr >= 0) & (rows + dr < m) & (cols + ds >= 0) & (cols + ds < n)
            shifted = torch.roll(P, (-dr, -ds), (1, 2))
            d = F.conv2d(((P - shifted) ** 2)[:, None], kernel)[:, 0]  # (N, m, n)
            w = torch.where(valid, torch.exp(-d / h2), 0.0)
            num = num + w * shifted[:, f : f + m, f : f + n]
            den = den + w
            wmax = torch.maximum(wmax, w)
    num = num + wmax * x
    den = den + wmax
    out = torch.where(den > 0, num / den, x)
    return out[0] if single else out


def nlm_classic_column_batch(
    G: torch.Tensor, h: torch.Tensor, search_radius: int = 3, patch_radius: int = 3
) -> torch.Tensor:
    """:func:`nlm_classic` of every row of G (nB, K) taken as a (K, 1)
    image with its own h (nB,), collapsed exactly to 1-D: the solver's
    `matlab` path (80 ISTA iterations over every block).

    In a width-1 image only the shifts along the column (ds = 0) keep their
    neighbour inside the image, and the symmetric padding repeats the one
    column, so the 7x7 ring-kernel distance is a 7-tap filter with the
    kernel's row sums, and the 48 shifts are 6.  ``tests/test_torch_matlab.py``
    pins this against the general :func:`nlm_classic` of both packages.
    """
    t, f = search_radius, patch_radius
    x = G.to(torch.float32)
    K = x.shape[1]
    P = x[:, np_pad_index(K, f, "symmetric", x.device)]  # (nB, K + 2f)
    taps = torch.from_numpy(_ring_kernel(f).sum(axis=1)).to(x.device)[None, None]
    h2 = torch.clamp(h.to(torch.float32).reshape(-1, 1) ** 2, min=1e-30)
    rows = torch.arange(K, device=x.device)[None, :]

    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    wmax = torch.zeros_like(x)
    for dr in range(-t, t + 1):
        if dr == 0:
            continue
        valid = (rows + dr >= 0) & (rows + dr < K)
        shifted = torch.roll(P, -dr, 1)
        d = F.conv1d(((P - shifted) ** 2)[:, None], taps)[:, 0]  # (nB, K)
        w = torch.where(valid, torch.exp(-d / h2), 0.0)
        num = num + w * shifted[:, f : f + K]
        den = den + w
        wmax = torch.maximum(wmax, w)
    num = num + wmax * x
    den = den + wmax
    return torch.where(den > 0, num / den, x)
