"""Floating-point operations of the solver's work, counted from shapes.

A multiply-add counts as two.  Counted: the matrix products and
convolutions; not counted: elementwise work (the NLM, batch norm, the
activations, Adam, the fidelity and dual updates) and ``eigh``.  So a share
of a peak from these counts is a lower bound of the work done."""

from __future__ import annotations

from reference import skip128

from . import b1


def sparse_step(nB: int, P: int, K: int, n_iter: int) -> int:
    """The sparse prox of one outer step: B1's loop and the reconstruction
    x D^T."""
    return b1.flops(nB, P, K, n_iter) + 2 * nB * P * K


def specnorm(nB: int, P: int, K: int, power_iters: int) -> int:
    """The step sizes by power iteration: two products per iteration and
    two more for the Rayleigh quotient."""
    return (power_iters + 1) * 4 * nB * P * K


def svt_gram(P: int, B: int) -> int:
    """The SVT through the B x B Gram matrix: X^T X, X V and (.) V^T."""
    return 3 * 2 * P * B * B


def lrs_pnp_tile(s, height: int, width: int, bands: int, atoms: int, nB: int, steps: int) -> int:
    """One tile's ``lrs_pnp`` solve: its step sizes (power iterations for
    ``specnorm``) and ``steps`` outer steps of sparse prox and SVT; ``s`` is
    the reference's :class:`~reference.solver.Setup`."""
    P, bb2 = height * width, s.block_size ** 2
    alpha = specnorm(nB, bb2, atoms, s.power_iters) if s.alpha_mode == "specnorm" else 0
    return alpha + steps * (sparse_step(nB, bb2, atoms, s.n_iter) + svt_gram(P, bands))


def dip_fit(height: int, width: int, bands: int, iterations: int) -> int:
    """The convolutions of ``iterations`` iterations of a skip-128 fit."""
    return iterations * skip128.fit_flops_per_iteration(height, width, bands)
