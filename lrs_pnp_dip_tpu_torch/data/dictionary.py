"""Sparse-coding dictionary learning and the shipped dictionary (counterpart
of ``lrs_pnp_dip_tpu/data/dictionary.py``).

Alternating minimisation over all training patches at once:

  * sparse step: batched ISTA with soft thresholding (two large matrix
    products per iteration);
  * dictionary step: the method of optimal directions (MOD),
    ``D = Y Z^T (Z Z^T + eps I)^{-1}``, or an approximate K-SVD sweep, then
    column normalisation (reference ``LRS-PnP(Matlab Code)/columnNormalise.m``);
  * under a mask, masked ISTA and a few projected-gradient steps on the
    masked residual, so that unobserved entries never train into atoms.

Patches are the solver's spatio-spectral blocks (``block_size`` consecutive
pixels x ``block_size`` consecutive bands of the matricized cube, band-major),
so the atoms live in the space the PnP-ISTA stage codes against.

The products are plain large matrix products (``torch.matmul``) and the
Lipschitz constants exact spectral norms, as the JAX package leaves them to
XLA.  Inputs and outputs of :func:`learn_dictionary` are numpy arrays; the
work runs on ``device``: the card by default, which raises when there is
none.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .io import matricize

_ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "artifacts")


def column_normalize(D, eps: float = 1e-12) -> torch.Tensor:
    """Scale every atom (column) to unit l2 norm."""
    D = torch.as_tensor(D)
    return D / (torch.linalg.vector_norm(D, dim=0, keepdim=True) + eps)


def random_dictionary(patch_dim: int, n_atoms: int, seed: int = 0) -> np.ndarray:
    """Gaussian random dictionary with unit-norm atoms (fallback/tests)."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((patch_dim, n_atoms)).astype(np.float32)
    return column_normalize(torch.from_numpy(D)).numpy()


def _lipschitz(A: torch.Tensor) -> torch.Tensor:
    """||A||_2^2 + 1e-6: the largest singular value, squared."""
    return torch.linalg.matrix_norm(A, ord=2) ** 2 + 1e-6


def _soft(G: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    return torch.sign(G) * torch.clamp(torch.abs(G) - thresh, min=0.0)


def _ista_code(Y: torch.Tensor, D: torch.Tensor, lam: float, n_iter: int) -> torch.Tensor:
    """Batched ISTA for min_Z 0.5||Y - D Z||^2 + lam ||Z||_1.

    Y: (P, N) patches as columns;  D: (P, K);  returns Z: (K, N).
    """
    L = _lipschitz(D)
    Z = torch.zeros((D.shape[1], Y.shape[1]), dtype=Y.dtype, device=Y.device)
    for _ in range(n_iter):
        R = Y - D @ Z
        Z = _soft(Z + (D.T @ R) / L, lam / L)
    return Z


def _ista_code_masked(
    Y: torch.Tensor, M: torch.Tensor, D: torch.Tensor, lam: float, n_iter: int
) -> torch.Tensor:
    """Masked batched ISTA: min_Z 0.5||M (Y - D Z)||^2 + lam||Z||_1.

    Unobserved entries (M == 0) contribute nothing to the gradient, so the
    code is fit to the observed pixels only.
    """
    L = _lipschitz(D)
    Z = torch.zeros((D.shape[1], Y.shape[1]), dtype=Y.dtype, device=Y.device)
    for _ in range(n_iter):
        R = M * (Y - D @ Z)
        Z = _soft(Z + (D.T @ R) / L, lam / L)
    return Z


def _mod_step(Y: torch.Tensor, D: torch.Tensor, lam: float, sparse_iters: int) -> torch.Tensor:
    Z = _ista_code(Y, D, lam, sparse_iters)
    K = D.shape[1]
    G = Z @ Z.T + 1e-6 * torch.eye(K, dtype=Y.dtype, device=Y.device)
    D_new = torch.linalg.solve(G, (Y @ Z.T).T).T
    # keep the previous atom where an atom collapsed to ~zero
    norms = torch.linalg.vector_norm(D_new, dim=0, keepdim=True)
    D_new = torch.where(norms > 1e-8, D_new, D)
    return column_normalize(D_new)


def _masked_mod_step(
    Y: torch.Tensor, M: torch.Tensor, D: torch.Tensor, lam: float, sparse_iters: int,
    dict_steps: int = 8,
) -> torch.Tensor:
    """One masked alternating-minimisation sweep.

    The masked least-squares dictionary update has no batched closed form
    (every pixel row p solves its own (Z W_p Z^T) system), so the update is
    a few projected-gradient steps on 0.5||M (Y - D Z)||^2 with the step
    size 1/||Z||_2^2, followed by column normalisation.
    """
    Z = _ista_code_masked(Y, M, D, lam, sparse_iters)
    eta = 1.0 / _lipschitz(Z)
    for _ in range(dict_steps):
        R = M * (Y - D @ Z)
        D = D + eta * (R @ Z.T)
    norms = torch.linalg.vector_norm(D, dim=0, keepdim=True)
    D = torch.where(norms > 1e-8, D, D + 1e-3)  # revive collapsed atoms
    return column_normalize(D)


def _aksvd_step(Y: torch.Tensor, D: torch.Tensor, lam: float, sparse_iters: int) -> torch.Tensor:
    """One approximate-K-SVD sweep (Rubinstein-style): sparse-code, then
    update every atom (and its coefficient row) against the residual, one
    atom after another."""
    Z = _ista_code(Y, D, lam, sparse_iters)  # (K, N)
    R = Y - D @ Z  # residual, maintained incrementally
    D = D.clone()
    for k in range(D.shape[1]):
        d, g = D[:, k].clone(), Z[k].clone()
        # E_k = R + d g^T ;  d_new ∝ E_k g
        d_new = R @ g + d * torch.dot(g, g)
        norm = torch.linalg.vector_norm(d_new)
        d_new = torch.where(norm > 1e-8, d_new / torch.clamp(norm, min=1e-8), d)
        g_new = R.T @ d_new + g * torch.dot(d, d_new)
        # keep the support of the sparse code (classic K-SVD updates only
        # coefficients that were already nonzero)
        g_new = torch.where(g != 0, g_new, torch.zeros_like(g_new))
        R = R + torch.outer(d, g) - torch.outer(d_new, g_new)
        D[:, k] = d_new
        Z[k] = g_new
    return column_normalize(D)


def extract_training_patches(
    cubes: Sequence[np.ndarray],
    block_size: int = 36,
    stride: int = 4,
    masks: Optional[Sequence[np.ndarray]] = None,
):
    """Spatio-spectral training patches from cubes, as a numpy (patch_dim, N).

    Each cube (H, W, B) is matricized to (H*W, B); patches are
    ``block_size`` consecutive pixel rows x ``block_size`` consecutive bands,
    flattened band-major to match the solver's block layout
    (:mod:`..ops.blocks`).  Pixel windows step by ``stride * block_size``,
    band windows by ``stride``.

    If ``masks`` is given (one (H, W) observation mask per cube, 1 =
    observed, broadcast over bands), also returns the matching (patch_dim, N)
    mask patches, so callers can exclude or down-weight unobserved entries.
    """
    cols = []
    mask_cols = []
    for idx, cube in enumerate(cubes):
        Y = matricize(np.asarray(cube, dtype=np.float32))
        P, B = Y.shape
        if masks is not None:
            m2d = np.asarray(masks[idx], dtype=np.float32).reshape(-1)
            M = np.broadcast_to(m2d[:, None], (P, B))
        for x in range(0, P - block_size + 1, stride * block_size):
            for y in range(0, B - block_size + 1, stride):
                cols.append(Y[x : x + block_size, y : y + block_size].T.reshape(-1))
                if masks is not None:
                    mask_cols.append(M[x : x + block_size, y : y + block_size].T.reshape(-1))
    patches = np.stack(cols, axis=1)
    if masks is not None:
        return patches, np.stack(mask_cols, axis=1)
    return patches


def load_trained_dictionary(n_atoms: int = 512) -> np.ndarray:
    """Load ``artifacts/dictionary_36x36_k{n_atoms}.npz`` as a (1296, n_atoms)
    float32 array (trained by ``scripts/train_dictionary.py``)."""
    path = os.path.join(_ARTIFACTS, f"dictionary_36x36_k{n_atoms}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found")
    with np.load(path) as f:
        return np.asarray(f["dictionary"], dtype=np.float32)


def learn_dictionary(
    patches: np.ndarray,
    n_atoms: int = 512,
    lam: float = 0.05,
    n_outer: int = 20,
    sparse_iters: int = 30,
    seed: int = 0,
    method: str = "mod",
    mask_patches: Optional[np.ndarray] = None,
    device="cuda",
) -> np.ndarray:
    """Learn a (patch_dim, n_atoms) dictionary from (patch_dim, N) patches.

    ``method``: 'mod' (method of optimal directions; batched) or 'ksvd'
    (approximate K-SVD; per-atom rank-1 updates, the algorithm family the
    reference's MATLAB-era dictionary came from).

    ``mask_patches`` (same shape as ``patches``, 1 = observed): when given,
    learning is mask-aware: unobserved entries contribute to neither the
    sparse codes nor the dictionary update, so zero-filled holes never train
    into atoms.

    The atoms start from ``n_atoms`` training patches drawn by
    ``np.random.default_rng(seed)`` plus 1e-3 Gaussian noise from the same
    generator, as in the JAX package, so both start from equal atoms.  Runs
    on ``device`` (the card by default; ``device='cpu'`` for the CPU) and
    returns a float32 numpy array.
    """
    dev = resolve_device(device)
    patches = torch.as_tensor(np.asarray(patches, np.float32), device=dev)
    patch_dim, n = patches.shape
    rng = np.random.default_rng(seed)
    # standard K-SVD init from random training patches; under a mask the
    # unobserved entries are zeroed, so hole contents never reach the atoms
    init_idx = torch.as_tensor(rng.choice(n, size=n_atoms, replace=n < n_atoms), device=dev)
    M = None
    init_patches = patches
    if mask_patches is not None:
        M = torch.as_tensor(np.asarray(mask_patches, np.float32), device=dev)
        init_patches = patches * M
    noise = torch.as_tensor(rng.standard_normal((patch_dim, n_atoms)).astype(np.float32), device=dev)
    D = column_normalize(init_patches[:, init_idx] + 1e-3 * noise)
    if M is not None:
        for _ in range(n_outer):
            D = _masked_mod_step(patches, M, D, lam, sparse_iters)
    else:
        step = _mod_step if method == "mod" else _aksvd_step
        for _ in range(n_outer):
            D = step(patches, D, lam, sparse_iters)
    return D.cpu().numpy()
