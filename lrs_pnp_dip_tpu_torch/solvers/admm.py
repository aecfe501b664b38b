"""The ADMM-style outer solver (counterpart of ``lrs_pnp_dip_tpu/solvers/admm.py``).

Per outer iteration (``main_LRS_PnP_DIP_pro.py:355-528``,
``main_LRS_PnP.py:250-366``, ``main_LRS_PnP_DIP_1-LiP.py:347-520``):

  1. sparse prox:   blocks(X + l1/mu1) -> per-block PnP-ISTA -> Phi_z
  2. low-rank prox: U = SVT(X + l2/mu2, 1/mu2)                      (lrs_pnp)
                    U = DIP-train(target=noisy, input=X + l2/mu2)   (dip, dip_1lip)
  3. closed-form X update (mask-aware data fidelity)
  4. dual updates l1 += mu1(X - IMout), l2 += mu2(X - U)
  5. diagnostics: MPSNR, SSIM, log||state - prev||

:class:`OuterStages` holds those stages for one problem geometry;
:func:`build_step` strings them into the single-problem step and
:mod:`.batch` into the lockstep step of several problems.
:meth:`Solver.run` steps the outer loop from the host, and each step's DIP
fit runs as one device program (its captured iteration replayed, as the
JAX package's jitted step runs its ``while_loop``);
:meth:`Solver.run_scanned` is the device-resident loop of
:mod:`.scan` (CUDA graphs on the card), the counterpart of the JAX
package's ``lax.scan``.
"""

from __future__ import annotations

import time
from typing import Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..data.io import HsiSample
from ..models import LipschitzUNet, dip_skip_128, get_net
from ..ops.blocks import block_grid, extract_blocks, scatter_blocks
from ..ops.fidelity import data_fidelity_update, dual_updates
from ..ops.ista import compute_alpha, sparse_prox
from ..ops.metrics import mpsnr
from ..ops.ssim import ssim
from ..ops.svt import svt_gram
from ..utils.config import SolverConfig
from ..utils.device import resolve_device
from ..utils.profiling import annotate
from .dip import FIT_CHUNK, make_dip_fit


class SolverState(NamedTuple):
    """Carried ADMM state."""

    X: torch.Tensor  # (P, B) current estimate
    lambda1: torch.Tensor  # (P, B) sparsity dual
    lambda2: torch.Tensor  # (P, B) low-rank dual
    generator: torch.Generator  # draws each step's fresh DIP init (and noise input)
    itr: int  # outer iteration counter


class ProblemConsts(NamedTuple):
    """Per-problem constants (``clean`` is a NaN cube without ground truth)."""

    Y: torch.Tensor  # (P, B) observed matricized image
    mask2d: torch.Tensor  # (P, B) observation mask
    mask_blocks: torch.Tensor  # (nB, bb*bb) observed-entry mask per block
    D: torch.Tensor  # (bb*bb, K) dictionary
    clean: torch.Tensor  # (H, W, B) ground truth (or NaN)
    dip_target: torch.Tensor  # (1, H, W, B) fixed noisy target
    dip_mask: torch.Tensor  # (1, H, W, 1) observation mask for the DIP loss
    alpha: torch.Tensor  # (nB,) per-block ISTA step sizes, once per problem


class StepAux(NamedTuple):
    """Per-iteration diagnostics."""

    mpsnr: torch.Tensor  # vs clean (NaN when no ground truth)
    ssim: torch.Tensor
    x_dist: torch.Tensor  # log||X - X_prev||
    l1_dist: torch.Tensor
    l2_dist: torch.Tensor
    dip_iters: int  # DIP iterations run (0 for lrs_pnp)
    dip_loss: torch.Tensor
    U: torch.Tensor  # low-rank / DIP prox output
    phi_scatter: torch.Tensor  # sparse-prox image


def _log_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.linalg.norm(a - b))


class SolverDiverged(RuntimeError):
    """Raised when the iterate goes non-finite or stalls exactly."""


def default_net(config: SolverConfig, n_bands: int):
    """The variant's DIP net: skip-128 for `dip`, the Lipschitz U-Net for
    `dip_1lip`, ``get_net(config.dip_net)`` when one is named, None for
    `lrs_pnp`."""
    if config.dip_net != "default":
        return get_net(n_bands, config.dip_net, pad="reflection", n_channels=n_bands)
    if config.variant == "dip":
        return dip_skip_128(num_channels=n_bands)
    if config.variant == "dip_1lip":
        return LipschitzUNet(
            n_bands,
            num_output_channels=n_bands,
            width=config.net_width,
            ln_lambda=config.ln_lambda,
            sn_mode=config.sn_mode,
        )
    return None


class OuterStages:
    """The stages of one outer step for one problem geometry.

    ``net`` replaces the variant's default DIP net; ``svt_fn(Z, tau)``
    replaces :func:`..ops.svt.svt_gram`; ``dip_init(itr)``, when given,
    returns the state dict each outer step's DIP fit starts from (else the
    net is re-drawn from ``state.generator``).  The sharded engine
    (:mod:`..parallel.engine`) sets the two other hooks:
    ``sparse_prox_fn(blocks, mask_blocks, D, alpha=None)`` replaces
    :func:`..ops.ista.sparse_prox` with the config's sparse settings, and
    ``dip_fit_factory(net, dip_config)`` replaces :func:`.dip.make_dip_fit`
    (channel TP of the net, or the fit on one rank with its result
    broadcast).  Without them the step is the unsharded one, bit for bit.

    ``fit_chunk`` is the chunk :meth:`low_rank` gives the DIP fit:
    ``FIT_CHUNK`` when the fit says it ``takes_chunk`` (a
    :class:`.dip.DipFit`, or the sharded engine's fit on one rank), so that
    on the card every step replays the fit's captured iteration; None for a
    fit that does not, which is called as it always was.  Setting it to None
    steps the fit from the host, which is how the tests and
    ``chip_smoke.py`` hold the replayed fit to the host-stepped one."""

    def __init__(
        self,
        config: SolverConfig,
        image_shape: tuple,  # (H, W, B)
        net=None,
        svt_fn: Optional[Callable] = None,
        dip_init: Optional[Callable[[int], Mapping[str, torch.Tensor]]] = None,
        device="cuda",
        sparse_prox_fn: Optional[Callable] = None,
        dip_fit_factory: Optional[Callable] = None,
    ):
        self.device = resolve_device(device)
        self.config = cfg = config
        self.image_shape = h, w, b = tuple(image_shape)
        self.grid = block_grid((h * w, b), cfg.block_size, cfg.stride)
        self.svt_fn = svt_fn or svt_gram
        self.sparse_prox_fn = sparse_prox_fn or (
            lambda blocks, mask_blocks, D, alpha=None: sparse_prox(
                blocks, mask_blocks, D, cfg.sparse, alpha=alpha
            )
        )
        self.dip_init = dip_init
        self.dip_fit = None
        self.fit_chunk: Optional[int] = None
        if cfg.variant in ("dip", "dip_1lip"):
            if cfg.dip.input_mode not in ("iterate", "noise"):
                raise ValueError(
                    f"DipConfig.input_mode must be 'iterate' or 'noise', "
                    f"got {cfg.dip.input_mode!r}"
                )
            net = (net or default_net(cfg, b)).to(self.device)
            self.dip_fit = (dip_fit_factory or make_dip_fit)(net, cfg.dip)
            if getattr(self.dip_fit, "takes_chunk", False):
                self.fit_chunk = FIT_CHUNK
        elif cfg.variant != "lrs_pnp":
            raise ValueError(f"unknown variant {cfg.variant!r}")

    def sparse_blocks(self, state: SolverState) -> torch.Tensor:
        """The sparse prox's target blocks (nB, bb*bb)."""
        return extract_blocks(state.X + state.lambda1 / self.config.mu1, self.grid)

    def sparse(self, state: SolverState, consts: ProblemConsts) -> torch.Tensor:
        """Stage 1 of one problem: the reconstructed blocks Phi_z (nB, bb*bb)."""
        return self.sparse_prox_fn(
            self.sparse_blocks(state), consts.mask_blocks, consts.D, alpha=consts.alpha
        )

    def low_rank_input(self, state: SolverState) -> torch.Tensor:
        """The low-rank prox's input X + lambda2/mu2 (any leading axes)."""
        return state.X + state.lambda2 / self.config.mu2

    def svt(self, Z: torch.Tensor) -> torch.Tensor:
        """The `lrs_pnp` low-rank prox; takes a leading batch axis."""
        return self.svt_fn(Z, 1.0 / self.config.mu2)

    def low_rank(self, state: SolverState, consts: ProblemConsts):
        """The low-rank / DIP prox: (U, dip_iters, dip_loss).  The DIP fit
        takes one problem, with ``fit_chunk``; the `lrs_pnp` SVT also takes
        a stacked state (a leading lane axis), as one batched ``eigh``."""
        cfg = self.config
        h, w, b = self.image_shape
        Z = self.low_rank_input(state)
        if self.dip_fit is None:
            return self.svt(Z), 0, torch.zeros((), dtype=torch.float32, device=Z.device)
        if cfg.dip.input_mode == "noise":
            dip_input = cfg.dip.noise_var * torch.rand(
                (1, h, w, b), generator=state.generator, device=Z.device
            )
        else:
            dip_input = Z.reshape(1, h, w, b)
        res = self.dip_fit(
            dip_input, consts.dip_target, consts.dip_mask,
            init=None if self.dip_init is None else self.dip_init(state.itr),
            generator=state.generator,
            **({} if self.fit_chunk is None else {"chunk": self.fit_chunk}),
        )
        return res.out.reshape(h * w, b), res.n_iters, res.loss

    def finish(self, state: SolverState, consts: ProblemConsts, phi, U, dip_iters, dip_loss):
        """Stages 3 to 5 from the two prox outputs: (new_state, aux)."""
        cfg, grid = self.config, self.grid
        X, im_out = data_fidelity_update(
            consts.Y, consts.mask2d, phi, U, state.lambda1, state.lambda2,
            grid, cfg.gamma, cfg.mu1, cfg.mu2,
        )
        l1, l2 = dual_updates(state.lambda1, state.lambda2, X, im_out, U, cfg.mu1, cfg.mu2)
        cube = X.reshape(self.image_shape)
        aux = StepAux(
            mpsnr=mpsnr(consts.clean, cube),
            ssim=ssim(consts.clean, cube),
            x_dist=_log_dist(X, state.X),
            l1_dist=_log_dist(l1, state.lambda1),
            l2_dist=_log_dist(l2, state.lambda2),
            dip_iters=dip_iters,
            dip_loss=dip_loss,
            U=U,
            phi_scatter=scatter_blocks(phi, grid) / grid.weight(X.device),
        )
        return SolverState(X, l1, l2, state.generator, state.itr + 1), aux


def build_step(
    config: SolverConfig,
    image_shape: tuple,  # (H, W, B)
    net=None,
    svt_fn: Optional[Callable] = None,
    dip_init: Optional[Callable[[int], Mapping[str, torch.Tensor]]] = None,
    device="cuda",
    sparse_prox_fn: Optional[Callable] = None,
    dip_fit_factory: Optional[Callable] = None,
) -> Callable[[SolverState, ProblemConsts], tuple]:
    """Build the outer-step function ``step(state, consts) -> (state, aux)``
    of one problem; the arguments are :class:`OuterStages`'s."""
    return single_step(OuterStages(
        config, image_shape, net, svt_fn, dip_init, device, sparse_prox_fn, dip_fit_factory
    ))


def single_step(stages: OuterStages) -> Callable[[SolverState, ProblemConsts], tuple]:
    """The outer step of one problem through ``stages``."""

    def step(state: SolverState, consts: ProblemConsts):
        with annotate("step.sparse"):
            phi = stages.sparse(state, consts)
        low_rank = stages.low_rank(state, consts)
        with annotate("step.finish"):
            return stages.finish(state, consts, phi, *low_rank)

    return step


def make_consts(
    sample: HsiSample, dictionary, config: SolverConfig, device="cuda"
) -> ProblemConsts:
    """Assemble the per-problem constants on ``device``."""
    device = resolve_device(device)
    clean = None
    if sample.clean is not None:
        clean = torch.as_tensor(np.asarray(sample.clean, np.float32), device=device)
    return assemble_consts(
        torch.as_tensor(np.asarray(sample.noisy, np.float32), device=device),
        torch.as_tensor(np.asarray(sample.mask, np.float32), device=device),
        torch.as_tensor(np.asarray(dictionary, np.float32), device=device),
        config,
        clean,
    )


def assemble_consts(
    noisy: torch.Tensor,  # (..., H, W, B) observed cubes
    mask_hw: torch.Tensor,  # (..., H, W) observation masks
    D: torch.Tensor,  # (bb*bb, K) dictionary
    config: SolverConfig,
    clean: Optional[torch.Tensor] = None,  # (..., H, W, B), or None for a NaN cube
) -> ProblemConsts:
    """The constants of one problem, or of a stack of problems along the
    leading axes, from f32 tensors on their device.  ``Y``, ``dip_target``
    and ``dip_mask`` are views of ``noisy`` and ``mask_hw``.  The step sizes
    of a stack come from one :func:`..ops.ista.compute_alpha` over the
    blocks of every problem, each block's arithmetic its own."""
    *lead, h, w, b = noisy.shape
    Y = noisy.reshape(*lead, h * w, b)
    mask2d = mask_hw.reshape(*lead, h * w, 1).expand(*lead, h * w, b).contiguous()
    grid = block_grid((h * w, b), config.block_size, config.stride)
    # missing entries located once from the observed blocks
    # (reference ``blocks_copy``, ``main_LRS_PnP_DIP_pro.py:347``)
    mask_blocks = (extract_blocks(Y, grid) != 0).to(torch.float32)
    if clean is None:
        clean = torch.full(noisy.shape, float("nan"), dtype=torch.float32, device=noisy.device)
    alpha = compute_alpha(D, mask_blocks.reshape(-1, grid.patch_dim), config.sparse)
    return ProblemConsts(
        Y=Y,
        mask2d=mask2d,
        mask_blocks=mask_blocks,
        D=D,
        clean=clean,
        dip_target=noisy.unsqueeze(-4),
        dip_mask=mask_hw.unsqueeze(-3).unsqueeze(-1),
        alpha=alpha.reshape(mask_blocks.shape[:-1]),
    )


def init_state(sample_or_Y, seed: int = 0, device="cuda") -> SolverState:
    """X starts at the observed image, the duals at zero
    (reference ``main_LRS_PnP_DIP_pro.py:324-334``)."""
    device = resolve_device(device)
    if isinstance(sample_or_Y, HsiSample):
        h, w, b = sample_or_Y.shape
        Y = np.asarray(sample_or_Y.noisy, np.float32).reshape(h * w, b)
    else:
        Y = sample_or_Y
    Y = torch.as_tensor(Y, dtype=torch.float32, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return SolverState(
        X=Y, lambda1=torch.zeros_like(Y), lambda2=torch.zeros_like(Y),
        generator=generator, itr=0,
    )


class Solver:
    """Single-problem LRS-PnP / LRS-PnP-DIP / LRS-PnP-DIP(1-Lip) engine.  Runs on ``device`` ('cuda' by
    default; raises without a card unless ``device='cpu'``)."""

    def __init__(
        self,
        sample: HsiSample,
        dictionary: np.ndarray,
        config: SolverConfig,
        net=None,
        device="cuda",
        dip_init: Optional[Callable[[int], Mapping[str, torch.Tensor]]] = None,
        svt_fn: Optional[Callable] = None,
    ):
        self.device = resolve_device(device)
        self.sample = sample
        self.config = config
        self.height, self.width, self.n_bands = sample.shape
        self.stages = OuterStages(
            config, sample.shape, net=net, svt_fn=svt_fn, dip_init=dip_init, device=self.device
        )
        self._step = single_step(self.stages)
        self.consts = make_consts(sample, dictionary, config, device=self.device)
        self._scan = None

    def init_state(self, seed: Optional[int] = None) -> SolverState:
        return init_state(
            self.sample, self.config.seed if seed is None else seed, device=self.device
        )

    def step(self, state: SolverState):
        return self._step(state, self.consts)

    def run(
        self,
        n_iters: Optional[int] = None,
        state: Optional[SolverState] = None,
        callback: Optional[Callable[[int, SolverState, StepAux], None]] = None,
    ):
        """Run the outer loop; returns (final_state, history dict).

        ``history['seconds']`` holds each outer step's wall time; reading
        the step's scalars waits for the device, so it covers the device
        work too."""
        n = self.config.outer_iters if n_iters is None else n_iters
        state = self.init_state() if state is None else state
        keys = ("mpsnr", "ssim", "x_dist", "l1_dist", "l2_dist", "dip_iters")
        hist = {k: [] for k in keys + ("seconds",)}
        best = (-np.inf, None)
        for i in range(n):
            t0 = time.perf_counter()
            state, aux = self.step(state)
            with annotate("step.read"):
                for k in keys:
                    hist[k].append(float(getattr(aux, k)))
                hist["seconds"].append(time.perf_counter() - t0)
                # x_dist is log||dX||: NaN/+inf means a non-finite iterate, -inf
                # an exactly stalled one, which a healthy DIP step never gives and
                # the deterministic lrs_pnp only at a degenerate fixed point
                # (an all-zero X, say)
                if not np.isfinite(hist["x_dist"][-1]):
                    kind = (
                        "exactly-stalled (||dX|| == 0)"
                        if hist["x_dist"][-1] == -np.inf
                        else "non-finite"
                    )
                    raise SolverDiverged(
                        f"{kind} iterate at outer iteration {i} "
                        f"(variant={self.config.variant}); last finite MPSNR "
                        f"{best[0]:.3f} — checkpoint and inspect duals/step sizes"
                    )
                if hist["mpsnr"][-1] > best[0]:
                    best = (hist["mpsnr"][-1], state.X.detach().cpu().numpy())
            if callback is not None:
                callback(i, state, aux)
        hist["best_mpsnr"] = best[0]
        hist["best_X"] = best[1]
        return state, hist

    def run_scanned(self, n_iters: Optional[int] = None, state: Optional[SolverState] = None):
        """Run ``n_iters`` outer steps on the device; returns (final_state,
        history) with ``mpsnr``, ``ssim``, ``x_dist``, ``l1_dist``,
        ``l2_dist`` and ``dip_iters``, each a numpy array of length n, read
        from the device once at the end.

        On the card each step replays captured graphs (:mod:`.scan`), and
        the DIP fit replays its own; the first call captures them.  On the
        CPU the same bodies run eagerly and give :meth:`run`'s bits.  No
        divergence check and no ``best_X``: the loop reads nothing back."""
        from .scan import ScannedSolve

        n = self.config.outer_iters if n_iters is None else n_iters
        state = self.init_state() if state is None else state
        if self._scan is None:
            self._scan = ScannedSolve(self.stages, self.consts)
        state, rows = self._scan.run(state, n)
        keys = ("mpsnr", "ssim", "x_dist", "l1_dist", "l2_dist", "dip_iters")
        hist = {k: rows[:, j] for j, k in enumerate(keys)}
        hist["dip_iters"] = hist["dip_iters"].astype(np.int32)
        return state, hist

    def result_cube(self, state: SolverState) -> np.ndarray:
        return state.X.detach().cpu().numpy().reshape(self.height, self.width, self.n_bands)


def solve(
    sample: HsiSample,
    dictionary: np.ndarray,
    config: SolverConfig,
    n_iters: Optional[int] = None,
    callback=None,
    device="cuda",
):
    """One-call solve.  Returns (cube, history)."""
    solver = Solver(sample, dictionary, config, device=device)
    state, hist = solver.run(n_iters=n_iters, callback=callback)
    return solver.result_cube(state), hist
