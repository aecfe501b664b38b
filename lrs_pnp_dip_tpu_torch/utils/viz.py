"""Visualization: per-iteration result panels and convergence figures
(counterpart of ``lrs_pnp_dip_tpu/utils/viz.py``).

Mirrors the reference's matplotlib output: a row of clean / corrupted /
result / ground-truth-hole / generated-hole panels with a zoomed inset on
the result and MPSNR/MSSIM in the xlabels (``main_LRS_PnP_DIP_pro.py:498-526``),
and the final 2x2 convergence figure (``:537-566``).  Headless (Agg) by
default.  The writers take tensors (on any device) or arrays; matplotlib is
imported only when a figure is written.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_iteration_panel(
    path: str,
    sample,
    solver,
    state,
    aux,
    band: int = 80,
    zoom_box=(14, 19, 13, 23),
):
    """Reference-style 5-7 panel figure for one outer iteration."""
    plt = _plt()
    from mpl_toolkits.axes_grid1.inset_locator import mark_inset, zoomed_inset_axes

    h, w, b = sample.shape
    band = min(band, b - 1)
    result = _np(state.X).reshape(h, w, b)
    hole = 1.0 - sample.mask
    panels = [
        ("Clean Image", sample.clean[..., band] if sample.clean is not None else None),
        ("Corrupted Image", sample.noisy[..., band]),
        ("Recovered", result[..., band]),
        ("Ground-Truth hole region",
         (sample.clean[..., band] * hole) if sample.clean is not None else None),
        ("Generated hole region", result[..., band] * hole),
        ("DIP/low-rank Out", _np(aux.U).reshape(h, w, b)[..., band]),
        ("Sparse Coding Out", _np(aux.phi_scatter).reshape(h, w, b)[..., band]),
    ]
    panels = [(t, img) for t, img in panels if img is not None]
    f, axes = plt.subplots(1, len(panels), sharey=True, figsize=(3 * len(panels), 4))
    for ax, (title, img) in zip(np.atleast_1d(axes), panels):
        ax.imshow(img, cmap="gray")
        ax.set_title(title, fontsize=8)
    res_ax = np.atleast_1d(axes)[2]
    try:
        axins = zoomed_inset_axes(res_ax, 1.8, loc=4)
        axins.imshow(result[..., band], cmap="gray")
        x0, x1, y0, y1 = zoom_box
        axins.set_xlim(x0, x1)
        axins.set_ylim(y1, y0)
        axins.set_xticks([])
        axins.set_yticks([])
        mark_inset(res_ax, axins, loc1=1, loc2=3, fc="none", ec="red")
    except Exception:
        pass
    np.atleast_1d(axes)[1].set_xlabel("Input")
    res_ax.set_xlabel(
        f"MPSNR {float(aux.mpsnr):.4f}  MSSIM {float(aux.ssim):.4f}", fontsize=8
    )
    f.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(f)


def save_convergence_figure(
    path: str,
    x_dist: Sequence[float],
    l1_dist: Sequence[float],
    l2_dist: Sequence[float],
    mpsnr: Sequence[float],
):
    """Reference-style 2x2 convergence figure."""
    plt = _plt()
    f, axis = plt.subplots(2, 2, figsize=(10, 8))
    for ax, (data, title, ylabel) in zip(
        axis.ravel(),
        [
            (x_dist, "Convergence of state x", r"$\log\Vert x^{k+1}-x^k\Vert$"),
            (l1_dist, r"Convergence of $\lambda_1$", r"$\log\Vert\lambda_1^{k+1}-\lambda_1^k\Vert$"),
            (l2_dist, r"Convergence of $\lambda_2$", r"$\log\Vert\lambda_2^{k+1}-\lambda_2^k\Vert$"),
            (mpsnr, "Inpainting Results", "MPSNR"),
        ],
    ):
        ax.plot(_np(data))
        ax.set_title(title)
        ax.set_xlabel("iteration Number k")
        ax.set_ylabel(ylabel)
    f.tight_layout()
    f.savefig(path, dpi=110)
    plt.close(f)


def save_spectrum(path: str, cube, pixel=(18, 18)):
    """Save the recovered spectrum of one pixel as .npy (the reference's
    ``results/spectrum/*/K.npy`` method-comparison artifacts)."""
    np.save(path, _np(cube)[pixel[0], pixel[1], :])
