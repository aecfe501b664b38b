"""BM3D denoiser: block matching and collaborative 3-D filtering
(counterpart of ``lrs_pnp_dip_tpu/ops/bm3d.py``).

Every function takes a batch of images with one strength each, where the
JAX package vmaps:

  * patches on a fixed stride grid (one gather with fixed index maps);
  * block matching as one all-pairs distance matrix (a Gram product)
    masked to the search radius, the ``group`` nearest taken in the order
    of ``jax.lax.top_k``: by distance, the lower index first among equal
    distances (a stable sort, the same on every device);
  * the 3-D transform as three small products (orthonormal DCT-II along
    rows, columns and the group);
  * hard threshold (stage 1) and empirical Wiener (stage 2) shrinkage;
  * aggregation over group membership, then onto the pixel grid, both in
    the order of ``index_add_`` on the CPU (a stable sort of the member ids,
    then passes in which no two values reach one sum), so that two calls
    give equal bits on the card too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Bm3dConfig:
    """BM3D parameters (the classic hard-threshold profile of the Tampere
    implementation; the same fields and defaults as the JAX package)."""

    patch: int = 8
    stride: int = 3  # Nstep: stage 2 relies on the denser cover
    group: int = 16  # patches per collaborative group
    search: int = 16  # Chebyshev matching radius (pixels)
    lambda3d: float = 2.7  # hard-threshold multiplier (stage 1)
    wiener: bool = True  # run the stage-2 Wiener refinement
    # Match-distance cutoffs (mean squared difference per pixel, [0, 1]
    # data): members farther than this from the reference patch are replaced
    # by the reference itself (Tampere's tau_match = 3000 / 255^2 and
    # tau_match_wiener = 400 / 255^2).
    tau_match: float = 3000.0 / 65025.0
    tau_match_wiener: float = 400.0 / 65025.0


def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (n, n)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    C = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    C[0] *= 1.0 / np.sqrt(2.0)
    return (C * np.sqrt(2.0 / n)).astype(np.float32)


def _grid(size: int, patch: int, stride: int) -> np.ndarray:
    """Patch start positions covering [0, size - patch], the last position
    appended when the stride does not land on it."""
    pos = list(range(0, size - patch + 1, stride))
    if pos[-1] != size - patch:
        pos.append(size - patch)
    return np.asarray(pos, np.int64)


class _Geometry:
    """Patch positions of an (H, W) image and their pixel indices."""

    def __init__(self, H: int, W: int, cfg: Bm3dConfig, device):
        self.p = p = min(cfg.patch, H, W)
        py, px = np.meshgrid(_grid(H, p, cfg.stride), _grid(W, p, cfg.stride), indexing="ij")
        self.py, self.px = py.reshape(-1), px.reshape(-1)
        self.nP = self.py.size
        ry = self.py[:, None] + np.arange(p)  # (nP, p)
        rx = self.px[:, None] + np.arange(p)
        # flat pixel index of every patch entry (nP, p, p)
        self.pix = torch.as_tensor(ry[:, :, None] * W + rx[:, None, :], device=device)
        cheb = np.maximum(
            np.abs(self.py[:, None] - self.py[None, :]), np.abs(self.px[:, None] - self.px[None, :])
        )
        self.near = torch.as_tensor(cheb <= cfg.search, device=device)

    def extract(self, img: torch.Tensor) -> torch.Tensor:
        """(N, H, W) -> all patches (N, nP, p, p)."""
        return img.reshape(img.shape[0], -1)[:, self.pix]


def _match(patches: torch.Tensor, geo: _Geometry, cfg: Bm3dConfig, tau: float) -> torch.Tensor:
    """Group indices (N, nP, g): the g nearest patches within the search
    radius (the patch itself included), members farther than ``tau`` (mean
    squared difference) replaced by the reference patch."""
    N, nP = patches.shape[:2]
    p2 = patches.shape[2] * patches.shape[3]
    flat = patches.reshape(N, nP, -1)
    sq = torch.sum(flat * flat, dim=2)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * (flat @ flat.transpose(1, 2))
    d2 = torch.where(geo.near, d2, torch.inf)
    g = min(cfg.group, nP)
    dist, idx = torch.sort(d2, dim=2, stable=True)
    dist, idx = dist[:, :, :g], idx[:, :, :g]
    self_idx = torch.arange(nP, device=patches.device)[None, :, None]
    return torch.where(dist <= tau * p2, idx, self_idx)


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Sums of the rows of ``vals`` (N, L, F) per segment id ``seg`` (N, L)
    in [0, n_seg): (N, n_seg, F).  Each segment's rows are added one at a
    time in the order they stand in ``vals``, the order of ``index_add_`` on
    the CPU, whatever the device: a stable sort of the ids puts each
    segment's rows in a run, and pass r adds the r-th row of every run
    longer than r (the runs' lengths read to the host once).  A pass meets
    no segment twice, so even the card's atomics add in one order; the work
    is linear in L."""
    N, L, F = vals.shape
    dev = vals.device
    flat = (seg + n_seg * torch.arange(N, device=dev)[:, None]).reshape(-1)
    order = torch.argsort(flat, stable=True)
    count = torch.bincount(flat, minlength=N * n_seg)
    by_len = torch.argsort(count, descending=True, stable=True)  # the longest runs first
    first = (torch.cumsum(count, 0) - count)[by_len]  # where each of them starts in ``order``
    lengths = count[by_len].cpu().numpy()
    longer = np.searchsorted(-lengths, -np.arange(lengths[0] if lengths.size else 0), side="left")
    rows = vals.reshape(N * L, F)
    out = vals.new_zeros(N * n_seg, F)
    for r, n in enumerate(longer.tolist()):  # n runs are longer than r
        out.index_add_(0, by_len[:n], rows.index_select(0, order.index_select(0, first[:n] + r)))
    return out.reshape(N, n_seg, F)


def _aggregate(filtered, weights, idx, geo: _Geometry, shape):
    """Weighted aggregation: group members summed per patch, then patches
    onto the pixel grid.  filtered (N, nP, g, p, p), weights (N, nP),
    idx (N, nP, g); returns num, den (N, H, W).

    Both sums add in the order of ``index_add_`` on the CPU, whatever the
    device, so that the card repeats its bits: the group members reach their
    patch through :func:`_segment_sum`, and the patches reach the pixels in
    p^2 passes, pass d adding entry d of every patch (no two patches put
    the same entry on one pixel), d from the last entry down, which adds
    each pixel's patches in the order of their index.  Work and memory stay
    linear in the group members, as with one ``index_add_``."""
    N, nP, g = idx.shape
    p2 = geo.p * geo.p
    H, W = shape
    vals = (filtered * weights[:, :, None, None, None]).reshape(N, nP * g, p2)
    wrep = weights[:, :, None].expand(N, nP, g).reshape(N, nP * g, 1)
    patch = _segment_sum(torch.cat([vals, wrep], dim=2), idx.reshape(N, nP * g), nP)  # (N, nP, p^2 + 1)
    entries = torch.stack([patch[:, :, :p2], patch[:, :, p2:].expand(N, nP, p2)], dim=3)  # num, den
    entries = entries.permute(2, 0, 1, 3).contiguous()  # (p^2, N, nP, 2)
    pix = geo.pix.reshape(nP, p2).T.contiguous()  # (p^2, nP)
    acc = patch.new_zeros(N, H * W, 2)
    for d in range(p2 - 1, -1, -1):
        acc.index_add_(1, pix[d], entries[d])
    return acc[:, :, 0].reshape(N, H, W), acc[:, :, 1].reshape(N, H, W)


def _bm3d_batch(img: torch.Tensor, sigma: torch.Tensor, cfg: Bm3dConfig) -> torch.Tensor:
    """BM3D of (N, H, W) f32 images with strengths sigma (N,)."""
    N, H, W = img.shape
    dev = img.device
    geo = _Geometry(H, W, cfg, dev)
    C = torch.from_numpy(_dct_matrix(geo.p)).to(dev)
    s = sigma.reshape(N, 1, 1, 1, 1)
    batch = torch.arange(N, device=dev)[:, None, None]

    def dct2(x):  # (..., p, p)
        return torch.einsum("ij,...jk,lk->...il", C, x, C)

    def idct2(x):
        return torch.einsum("ji,...jk,kl->...il", C, x, C)

    patches = geo.extract(img)
    idx = _match(patches, geo, cfg, cfg.tau_match)
    Tg = torch.from_numpy(_dct_matrix(idx.shape[2])).to(dev)
    coef2d = dct2(patches)  # (N, nP, p, p), shared across groups

    def transform3d(groups):  # (N, nP, g, p, p) of 2-D coefficients
        return torch.einsum("gh,bnhpq->bngpq", Tg, groups)

    def inverse3d(groups):
        return idct2(torch.einsum("hg,bngpq->bnhpq", Tg, groups))

    # stage 1: collaborative hard threshold
    c3 = transform3d(coef2d[batch, idx])
    keep = torch.abs(c3) >= cfg.lambda3d * s
    c3h = torch.where(keep, c3, 0.0)
    nret = torch.sum(keep.reshape(N, geo.nP, -1), dim=2).to(torch.float32)
    w_ht = 1.0 / torch.clamp(nret, min=1.0)
    num, den = _aggregate(inverse3d(c3h), w_ht, idx, geo, (H, W))
    basic = torch.where(den > 0, num / torch.clamp(den, min=1e-12), img)
    if not cfg.wiener:
        return basic

    # stage 2: empirical Wiener on the basic estimate
    bpatches = geo.extract(basic)
    idx2 = _match(bpatches, geo, cfg, cfg.tau_match_wiener)
    b3 = transform3d(dct2(bpatches)[batch, idx2])
    n3 = transform3d(coef2d[batch, idx2])
    Wsh = (b3 * b3) / (b3 * b3 + s * s + 1e-20)
    sig2 = (sigma * sigma).reshape(N, 1)
    w_wie = 1.0 / (sig2 * torch.sum(Wsh.reshape(N, geo.nP, -1) ** 2, dim=2) + 1e-12)
    num2, den2 = _aggregate(inverse3d(Wsh * n3), w_wie, idx2, geo, (H, W))
    return torch.where(den2 > 0, num2 / torch.clamp(den2, min=1e-12), basic)


def bm3d(img: torch.Tensor, sigma, cfg: Bm3dConfig = Bm3dConfig()) -> torch.Tensor:
    """Denoise an (H, W) image, or an (N, H, W) batch; ``sigma`` is the noise
    std, a scalar or one per image."""
    x = img.to(torch.float32)
    single = x.ndim == 2
    if single:
        x = x[None]
    s = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).reshape(-1)
    out = _bm3d_batch(x, s.expand(x.shape[0]), cfg)
    return out[0] if single else out


def bm3d_prox(x: torch.Tensor, sigma, cfg: Bm3dConfig = Bm3dConfig()) -> torch.Tensor:
    """PnP prox interface of the reference's ``bm3d_prox``
    (``admm_utils.py:60-75``): denoise each band of an (H, W) or (H, W, B)
    iterate at strength ``sigma``."""
    x = x.to(torch.float32)
    if x.ndim == 2:
        return bm3d(x, sigma, cfg)
    if x.ndim == 3:
        return bm3d(x.permute(2, 0, 1), sigma, cfg).permute(1, 2, 0)
    raise ValueError(f"bm3d_prox expects (H, W) or (H, W, B), got {tuple(x.shape)}")


def bm3d_coef_batch(G: torch.Tensor, h: torch.Tensor, cfg: Bm3dConfig) -> torch.Tensor:
    """BM3D as the PnP-ISTA coefficient denoiser: each block's (K,)
    coefficient vector folded to a (K/w, w) image (w the largest divisor of K
    up to sqrt(K)), denoised at its own strength ``h`` (nB,), unfolded."""
    nB, K = G.shape
    w = 1
    for cand in range(int(np.sqrt(K)), 0, -1):
        if K % cand == 0:
            w = cand
            break
    return bm3d(G.reshape(nB, K // w, w), h, cfg).reshape(nB, K)
