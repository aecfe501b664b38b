#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lrs_pnp_dip_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

  1. build   — compile kernel B1 (csrc/ista.cu) with nvcc for sm_90a;
  2. check   — kernel B1 against its plain PyTorch version on the card, at
               the main-path shape (nB 144, P 1296, K 512, 100 iterations,
               the shipped dictionary, masks of synthetic_sample(36, 36,
               128), trace4 alpha), a ragged nB 13 and nB 2304 (the 144x144
               cube), with f32 and bf16 operands, printing the tiling the
               plan chose for each; the same at the lrs_pnp sparse settings
               (80 iterations, specnorm alpha, h_scale 0.1); and two
               launches on the same inputs must give equal bits (the
               engines' shapes, nB 288 and 576, are held in phase 5); then
               at nB 144 the shapes past the resident kernel, with
               random dictionaries (wide_problem): blocks 40, 48 and 52 at K
               512 and P 1296 at K 1024, f32 and bf16, and P 576 at K
               1152, on the tier the plan picks, each against its plain
               loop, with equal bits on repeat, its plan (tier, waves,
               bytes of D through L2 per cluster and iteration) printed,
               bf16 held to the larger of
               1e-5 and 4 times the bf16 plain loop's floor (rows of D
               permuted, or its products on the tensor cores); the f32
               streamed kernel's tiles of 16 block rows at nB 240 (block 40,
               K 512; P 1296, K 1024), against the plain loop and timed
               beside 12 rows per cluster in two waves (wide_tiles_of_16);
               then the column kernel at nB 144 (LONG_K_SHAPES: P 1296 / K
               1152 f32, P 576 / K 2048 and P 256 / K 3000 f32 and bf16) the
               same way, timed beside its bound, plain loop and yardstick,
               and once at P 256 / K 3000, nB 13 (long_k_check); then at
               each shape of TIER_SHAPES (the main shape, nB 72, 288, 576
               and 2304, the auto-dictionary's P 576 at nB 324 and 1296,
               blocks 40, 48 and 52, K 1024 and 1152; random problems,
               tier_problem) every tiling of plan_candidates forced in turn
               against the plain loop, with equal bits on repeat, then all
               timed in turns (logged beside their predicted times), the
               bound and the yardstick, the plan's pick beside the fastest
               (tier_sweep);
  3. timing  — B1 at the main-path shape, at nB 2304 and at the streamed
               shapes with CUDA events, beside its bound, its plain version
               and the 2 n_iter torch.matmul calls (f32 and bf16);
  4. solve   — api.inpaint(variant="dip", n_iters=2) at full width (36x36x128,
               skip-128, 144 blocks, default DIP cap and early stop) on the
               card, counting B1's launches: Solver.run with each fit's
               captured iteration replayed FIT_CHUNK times per read of the
               stop flag; then the same 2 steps from the same seed through
               Solver.run in turns, each a new solver, with host-stepped
               and replayed fits (host, replayed, replayed, host): equal
               bits and dip_iters, the reads per fit, wall per step, and the
               warm step faster replayed in every turn; then one short outer
               step on the card against the same step on the CPU;
  5. paths   — every other path a user can call, each at full width on
               synthetic_sample(36, 36, 128, seed=0) with the shipped
               dictionary, each with B1's count set to 0 just before and
               read just after, each asserting finite output, a final MPSNR
               above the input's and the expected launches of B1:
               inpaint(variant="lrs_pnp") (the whole preset, also against the
               same solve on the CPU); inpaint(variant="dip_1lip"),
               inpaint(variant="dip_fast") (B1 with bf16 operands, the bf16
               DIP fit), the same with a random 1296x1024 unit-column
               dictionary (B1's streamed kernel in bf16, one launch per step),
               inpaint(variant="lrs_pnp") with a random 1296x1152
               dictionary (the whole preset on B1's column kernel in f32,
               one launch per step) and
               inpaint(variant="dip_tuned", seeds=[0, 1]) (one
               launch per outer step at nB 288), 2 outer steps each with the
               DIP fit capped at 50 iterations; dip_1lip, dip_fast and the
               dip_tuned lanes (SeedEnsembleSolver.run) each against the
               same 2 steps with host-stepped fits, equal bits;
               inpaint_scene(variant="lrs_pnp") on a 72x72x128 scene, four
               tiles in one batch (one launch per outer step at nB 576),
               also against the CPU; inpaint_scene(variant="dip") on it
               (solve_tiled(scan=False), fits capped at 50 and replayed)
               against host-stepped fits, equal bits; one concatenated launch of B1 against four per-lane
               launches; B1 against its plain version at nB 288 and at nB
               576 (dip and lrs_pnp settings), f32 and bf16; B1, the SVT and
               a batched SVT timed at these shapes;
  6. options — every other solver option on the card, each with B1's count
               set to 0 just before and read just after: the `matlab`
               preset (nlm_classic) through inpaint(variant="matlab") on
               matlab_twin_sample(seed=0, bands=128), all 13 outer steps,
               no launch of B1, and 2 steps against the CPU; sparse_prox
               with denoiser="bm3d" at nB 144 (5 iterations) and bm3d_prox
               on a 36x36x8 cube, card against CPU, no launch of B1, and two
               calls of each on the card give equal bits; every
               get_net key's forward on the card against the same weights
               on the CPU; one `dip` outer step at 36x36x128 with each key
               that keeps the iterate's shape (DIP fit capped at 50, each
               net's fit captured on first use), one launch of B1 at nB 144
               each, the device memory held after each and the peak, and
               each other key failing where the JAX package fails;
  7. long tail — the auto-dictionary and the rest of the JAX package's
               surface, at full width: inpaint(variant="dip", block_size=24,
               stride=24, n_iters=2) without dictionary= (it learns K atoms
               from the observed pixels; one launch of B1 per outer step at
               nB 324, P 576; DIP capped as in phase 5), the masked branch of
               the learning, learn_dictionary card against CPU (2 outer
               steps), B1 against its plain loop at nB 324 / P 576 (clusters
               of 8 in f32) with K 512, 196 (the eighth CTA owns no column)
               and 200 (four), f32 and bf16, timed at K 512 beside its bound
               and the f32 and bf16 matmul yardsticks; inpaint_scene(
               variant="lrs_pnp", block_size=24) without dictionary= on the
               72x72x128 scene (learned from the central probe; one launch per
               outer step at nB 4 x 324, tiles cut by the native library);
               checkpoint and resume of an lrs_pnp solve (equal bits) and of a
               dip solve's generator; fit() with adam, sgd and lbfgs; the
               native host library against the port's torch functions; one
               warm lrs_pnp outer step under utils.profiling.trace;
  8. parallel — the sharded engine (lrs_pnp_dip_tpu_torch.parallel), ranks
               spawned through its launcher sharing the one card over gloo
               with CUDA tensors, each case at full width (36x36x128, the
               shipped dictionary): (a) the {patch: 2} sparse prox at nB 144
               (72 per rank), f32 and bf16, and at nB 13 (one padding row),
               one launch of B1 per rank, the result equal bit for bit to
               one launch over all rows; (b) ShardedSolver on {patch: 2},
               the whole lrs_pnp preset, one launch per rank per step at nB
               72, X against the one-process solve, and 2 dip steps (DIP
               capped at 50), the fit chunked on the root rank, against the
               same ranks' host-stepped fits; (c) {patch: 2, band: 2},
               four ranks, one lrs_pnp step through the 2-D prox and SVT, no
               launch of B1; (d) {data: 2}, two samples, lrs_pnp, 2 steps, one
               launch per rank per step at nB 144, lanes against the
               one-process BatchedSolver, and 2 dip steps, each rank's lane
               fit chunked, against host-stepped fits; (e) {model: 2}, one
               dip step with channel TP of skip-128 (DIP capped at 50; the
               fit host-stepped by the mesh's choice), against the
               one-process step; (f) the two-rank multiprocess_dryrun; (g)
               in this process, inpaint(block_size=40) on the card: under
               the default backend B1's streamed kernel once per step (nB
               132, P 1600), against backend="xla" (the plain loop, no
               launch of B1); a shape past the TPU kernel's range (block
               54) raises the plan's ValueError naming backend="xla".  B1
               at nB 72 is timed beside its bound;
  9. scanned — the device-resident solve (CUDA graphs), at full width:
               B1 replayed from a captured graph against an eager launch
               (equal bits, f32 and bf16, one launch counted per replay),
               on the streamed kernel (block 40 in f32, P 1296 / K 1024 in
               bf16) and on the column kernel (P 1296 / K 1152 in f32, P 576
               / K 2048 in bf16, P 576 / K 1152 in f32 and bf16);
               the lrs_pnp preset's step through Solver.run_scanned against
               run (equal bits), each timed per step and sustained, with the
               kernels, host launches, host syncs and device-busy share of
               a step; `dip`, the preset, 2 outer steps through run_scanned
               against run from the same seed and against run with
               host-stepped fits, the DIP fit capped at 200, above its stop:
               dip_iters equal step by step, every fit stopped before the
               cap, X equal bits; phase 4's
               inpaint(variant="dip", n_iters=2) again, equal bits; for skip-128 f32 and bf16 and the Lipschitz U-Net, two
               eager fits equal, two graphed fits equal, graphed equal to
               eager, and ms per DIP iteration host-stepped against replayed,
               with each fit's profile, beside the same net in its
               unordered formulation (scripts/time_dip_formulations.py:
               F.pad reflection, cuDNN's default flags); one iteration of each
               solve-capable net under torch.use_deterministic_algorithms
               in a child process (scripts/probe_deterministic.py); one fit
               at chunk lengths 1, 8 and 32, capped at 200: each stops
               before the cap at the same iteration, and the iterations each
               replays after the stop;
               inpaint(variant="dip_tuned", seeds=[0, 1]) through run_chunked
               against SeedEnsembleSolver.run; inpaint_scene on the 72x72
               scene with scan=True against scan=False (equal bits); the
               yardstick of B1 at nB 72, 288, 576 and 2304 and its plain
               loop at nB 288, 576 and 2304;
 10. report  — the total time, the card's name and power limit, a
               {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.

Without a CUDA device, or without the package beside it, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Published dense peaks of the H100 SXM (NVIDIA data sheet): f32 on the CUDA
# cores, bf16 on the tensor cores, device-memory bandwidth.
H100_PEAKS = {"f32_flops": 67e12, "bf16_flops": 989e12, "bytes_per_s": 3.35e12}
# Kernel against the plain loop with the same operand type: the kernel sums
# the products in another order than cuBLAS.
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# With bf16 operands the summation order also flips an operand's rounding
# now and then, so the limit is on max |delta| over max |ref|.  It is below
# the gap that skipping the rounding of any operand leaves at the main-path
# shape (tests/test_torch_ista.py), so the check catches that.
BF16_MATCH = 1e-5
# At the lrs_pnp sparse settings (h_scale 0.1) the NLM's weights are ten times
# as sharp in h, and the bf16 plain loop itself moves by 1.1e-5 to 1.3e-5 of
# max |ref| when only the order of its sums changes (rows of D permuted, on
# the CPU: tests/test_torch_ista.py), so no kernel can meet 1e-5 there.  The
# limit is some 8 times that sensitivity; an f32 product still fails it.
BF16_MATCH_SHARP = 1e-4
# At the streamed and long-K shapes with random dictionaries the
# coefficients are smaller (max |ref| 0.005 to 0.09) and the bf16 plain loop
# moves by up to about 1e-5 of max |ref| when only the order of its sums
# changes, so phase 2 measures that floor on the card -- the larger of the
# plain loop with the rows of D permuted (order_sensitivity) and with its
# products on the tensor cores (tensor_core_sensitivity: mma.sync's
# accumulation) -- and holds the kernel to the larger of BF16_MATCH and this
# many times it, the rule of tests/test_torch_cuda.py (_assert_bf16_tracks);
# an f32 kernel still fails that limit.
BF16_ORDER_FACTOR = 4
# bf16 kernel against the f32 plain loop, as tests/test_ista_pallas.py.
BF16_DRIFT = 0.02
# A deterministic lrs_pnp solve on the card against the same solve on the
# CPU, max |delta| over max |X|: B1 against the plain loop, cuSOLVER's eigh
# against LAPACK's on an f32 Gram, two outer steps.  The CPU tests hold the
# port to the JAX package at the same figure.
SOLVE_MATCH = 1e-4
# Shapes past B1's resident kernel at nB 144 (wide_problem): (block, K,
# operand types).  Blocks 40, 48 and 52 at K 512 and P 1296 at K 1024 (f32
# slices past shared memory), P 576 at K 1152 (bf16 past 640 columns; in
# f32 the resident kernel takes it, 2 rows per cluster in 11 waves).  The
# plan takes the streamed tier at blocks 40 to 52 in f32 and at K 1024 in
# bf16, the column tier at K 1024 in f32 and at K 1152 (timed faster:
# tier_sweep).
WIDE_SHAPES = (
    (40, 512, ("float32", "bfloat16")),
    (48, 512, ("float32", "bfloat16")),
    (52, 512, ("float32", "bfloat16")),
    (36, 1024, ("float32", "bfloat16")),
    (24, 1152, ("float32", "bfloat16")),
)
# Shapes past the streamed tier's columns (K > 1024 in f32, > 1280 in bf16)
# that take B1's column tier at nB 144 (wide_problem): (block, K, operand
# types).  P 1296 at K 1152 (the reference block size past 1024 atoms), P
# 576 at K 2048 (the auto-dictionary's block, an overcomplete dictionary) and
# P 256 at K 3000.
LONG_K_SHAPES = (
    (36, 1152, ("float32",)),
    (24, 2048, ("float32", "bfloat16")),
    (16, 3000, ("float32", "bfloat16")),
)
# Shapes at which B1's plan chooses between its tiers (nB, P, K, operand
# types): the main shape, one rank's share of it under {patch: 2}, the
# dip_tuned lanes, the four-tile scene, the 144x144 cube, the auto-dictionary
# (block 24) solve and scene, block 40, blocks 48 and 52, 1024 atoms at block
# 36, 1152 atoms at block 24 and 36 (bf16).  Every candidate of plan_candidates
# is held to the plain loop and timed at each (tier_sweep,
# scripts/time_b1.py --tiers).
TIER_SHAPES = (
    (144, 1296, 512, ("float32", "bfloat16")),
    (72, 1296, 512, ("float32", "bfloat16")),
    (288, 1296, 512, ("float32", "bfloat16")),
    (576, 1296, 512, ("float32", "bfloat16")),
    (2304, 1296, 512, ("float32", "bfloat16")),
    (324, 576, 512, ("float32", "bfloat16")),
    (1296, 576, 512, ("float32", "bfloat16")),
    (132, 1600, 512, ("float32", "bfloat16")),
    (144, 2304, 512, ("float32", "bfloat16")),
    (144, 2704, 512, ("float32", "bfloat16")),
    (144, 1296, 1024, ("float32", "bfloat16")),
    (144, 576, 1152, ("float32", "bfloat16")),
    (144, 1296, 1152, ("bfloat16",)),
)
# The seed of the random 1296 x 1024 dictionary of phase 5's dip_fast path on
# B1's streamed kernel (bf16 past 640 columns).
WIDE_DICT_SEED = 1024
# The seed of the random 1296 x 1152 dictionary of phase 5's lrs_pnp path on
# B1's column kernel (f32 past 1024 columns).
LONG_DICT_SEED = 1152
# The DIP fit's cap in the paths of phases 5, 7 and 9 (the preset's is 5000):
# depth cut for the run's time (400 until phase 9 took the whole past 300 s
# on a slow host, 200 until the checks of B1's streamed kernel and of the
# fits' determinism were added, then 100), the early stop stays on.
DIP_CAP = 50
# The cap of phase 9's fits that check the early stop at full width (the
# preset's run against run_scanned, and the chunk lengths): above the
# preset's stop, which came at 163 and 177 iterations on the card, so that
# these fits stop before it.
STOP_CAP = 200
# The bm3d paths on the card against the CPU.  BM3D's hard threshold and its
# block matching are discontinuous, so the order of sums moves single values
# by far more than rounding: on the CPU, permuting the dictionary's rows
# moves the 5-iteration sparse prox at nB 144 by up to 1.8e-2 of max |ref|
# (2.0e-3 relative L2); a 1e-7 relative change of a 36x36x8 cube moves
# bm3d_prox by 1.8e-3 (2.9e-4 relative L2), and the card (its own order, its
# unordered index_add_) moved it by 5.0e-2 (3.6e-3).  So the sparse prox is
# held at some 5 times the CPU's sensitivity, (max |delta| / max |ref|,
# relative L2), and the cube's denoising by relative L2 and by what it is
# for: its MPSNR against the clean bands within 0.05 dB of the CPU's.
BM3D_PROX_MATCH = (0.1, 1e-2)
BM3D_CUBE_MATCH = (1e-2, 0.05)
# The zoo's forward on the card against the same weights on the CPU, max
# |delta| / max |out| (TF32 off: cuDNN and the CPU sum in other orders, and
# the train-mode batch norms over 1x1 to 4x4 maps amplify that: measured up
# to 8.3e-5, texture_nets at 36x36x128).
ZOO_MATCH = 5e-4
# The DIP fit's cap in the zoo's outer steps (100 until the checks of B1's
# streamed kernel and of the fits' determinism were added).
ZOO_DIP_CAP = 50
# learn_dictionary on the card against the CPU from the same patches, two
# outer steps at full width, relative L2 of the dictionaries.  MOD solves
# with Z Z^T + 1e-6 I, which is ill-conditioned at full width (atoms that few
# patches use), so the order of the sums alone moves the dictionary by far
# more than rounding: the limit is 4 times what
# the card's own learning moves when only the order of the patches changes,
# and at least LEARN_MATCH.  The dictionaries are also held by what they are
# for, the relative error with which they code the patches (LEARN_RECON).
LEARN_MATCH = 1e-3
LEARN_RECON = 1e-2
# A resumed lrs_pnp step against the uninterrupted one, max |delta| / max |X|,
# should cuSOLVER's eigh not repeat its bits (B1 does).
RESUME_MATCH = 1e-6
# The native host library's column NLM (double sums) against the port's
# (f32 on the card), max |delta| on coefficients of order 0.1 to 1.
NLM_MATCH = 1e-5


# Phase 8, ranks sharing the card over gloo, each held to the one-process
# port: the sharded lrs_pnp solve, X within SHARD_MATCH of max |X| (only the
# order of the Gram's sums differs: tests/test_parallel.py:58's 5e-4); the
# {data: 2} lanes within LANES_MATCH of the scale (tests/test_torch_batch.py).
# Channel TP of skip-128 over {model: 2}: the first step's gradient, all
# tensors as one vector, within TP_ORDER times the unsharded f32 gradient's
# relative L2 distance from the same gradient in f64, or TP_GRAD_REL, of the
# f64 one, with cuDNN's algorithms autotuned (cudnn.benchmark) for both; the
# same by cuDNN's heuristics, the port's default, is reported: they choose a
# less accurate weight-gradient algorithm for the split 64-channel kernels
# than for the whole ones.  The first output at
# tests/test_tensor_parallel.py:57's bounds.  (The elementwise gradient bounds
# of :57 hold at the tests' widths, not at full width: the batch norms leave
# f32 gradients of inner kernels about 9e-4 of their scale from f64.)
# Then one dip step capped at TP_DIP_CAP from one init, phi_scatter within
# 1e-5 of the one-process step, and X, the DIP loss and MPSNR within the
# larger of :156's bounds and TP_ORDER times what the same one-process step
# moves between the card and the CPU.  A DIP fit amplifies any change in the
# order of sums: on the CPU a 100-step fit of skip-128 at lr 1e-4 in f32 ends
# 0.13 from the same fit in f64 (max |U|), and at the preset's lr 0.1 the
# one-process step moves X by 8.6e-2 when only the thread count changes.  The
# step runs at lr TP_LR, as the dip_1lip step is compared
# (tests/test_torch_lipschitz.py): at 0.1 the MPSNR of two orders parts too.
SHARD_MATCH = 5e-4
LANES_MATCH = 1e-5
TP_GRAD_REL, TP_OUT_ATOL, TP_OUT_RTOL = 1e-3, 2e-3, 1e-2
TP_PHI_ATOL, TP_X_ATOL, TP_LOSS_RTOL, TP_MPSNR_RTOL = 1e-5, 5e-2, 5e-2, 1e-3
TP_ORDER = 4
TP_DIP_CAP = 50  # 100 until the checks of B1's streamed kernel and of determinism were added
TP_LR = 1e-4
# Seconds a spawn of ranks may take before they are stopped and the phase fails.
SPAWN_TIMEOUT = 300


# Outer steps of the lrs_pnp preset's step run back to back in phase 9 to
# time it sustained.
SCAN_STEPS = 20
# DIP iterations timed per fit (a multiple of FIT_CHUNK: no iteration wasted).
FIT_TIMED = 16

# get_net keys whose net does not keep the (1, H, W, B) shape of the iterate
# in a DIP solve, and the error the port raises there (the JAX package fails
# on each too: tests/test_torch_zoo.py).  The decoders' 32-fold output is
# 1152x1152 at 36x36.
ZOO_NO_SOLVE = {
    "texture_nets": RuntimeError, "UNet": RuntimeError, "UNet3D": ValueError,
    "deep_decoder": RuntimeError, "res_decoder": RuntimeError,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks_for(name: str) -> dict:
    if "H100" not in name:
        raise RuntimeError(f"no peaks for {name!r}: bound_ms is defined for an H100 only")
    return H100_PEAKS


def time_cuda(fn, warmup: int = 2, reps: int = 7) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, each bracketed by
    CUDA events, after ``warmup`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def problem(height: int, width: int, seed: int, dictionary, device="cuda", block_size: int = 36):
    """Blocks, masks and trace4 alpha of a synthetic cube, as the first
    outer step of the dip solve hands them to the sparse prox."""
    from lrs_pnp_dip_tpu_torch.data import synthetic_sample
    from lrs_pnp_dip_tpu_torch.ops import block_grid, extract_blocks
    from lrs_pnp_dip_tpu_torch.solvers import make_consts
    from lrs_pnp_dip_tpu_torch.utils.config import dip_preset

    sample = synthetic_sample(height, width, 128, seed=seed)
    cfg = dip_preset(block_size=block_size, stride=block_size)
    consts = make_consts(sample, dictionary, cfg, device=device)
    grid = block_grid((height * width, 128), cfg.block_size, cfg.stride)
    return extract_blocks(consts.Y, grid), consts.mask_blocks, consts.D, consts.alpha


def wide_problem(block: int, K: int, seed: int = 0, nB: int = 144):
    """nB blocks of ``block`` x ``block`` (P = block^2) of a 72x72x128
    synthetic cube with a random (P, K) dictionary of unit columns drawn
    from ``seed``: the inputs of B1 at a shape the shipped dictionary does not
    reach."""
    import numpy as np

    rng = np.random.default_rng(seed)
    D = rng.standard_normal((block * block, K)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    blocks, masks, D_t, alpha = problem(72, 72, seed, D, block_size=block)
    if blocks.shape[0] < nB:
        raise AssertionError(f"block {block}: {blocks.shape[0]} blocks, fewer than {nB}")
    return blocks[:nB], masks[:nB], D_t, alpha[:nB]


def check_kernel(blocks, masks, D, alpha, matmul_dtype: str, bf16_match=BF16_MATCH, with_scale=False,
                 **sparse):
    """Kernel B1 against the plain version on the same card tensors;
    returns max |delta| (with ``with_scale``, also max |ref|), raises when
    outside the tolerance.  With bf16
    operands it also holds the kernel to the f32 plain loop, and checks
    that the f32 kernel's output would fail the bf16 match.  ``sparse``
    overrides fields of the SparseProxConfig (100 iterations, trace4)."""
    import dataclasses

    import torch

    from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, pnp_ista_blocks, pnp_ista_blocks_fused
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    base = dataclasses.replace(SparseProxConfig(n_iter=100, alpha_mode="trace4"), **sparse)

    def run(fn, mm):
        return fn(blocks, masks, D, dataclasses.replace(base, matmul_dtype=mm), alpha=alpha)

    got = run(pnp_ista_blocks_fused, matmul_dtype)
    torch.cuda.synchronize()
    ref = run(pnp_ista_blocks, matmul_dtype)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output is not finite")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    note = ""
    if matmul_dtype == "float32":
        torch.testing.assert_close(got, ref, **F32_TOL)
    else:
        if not err < bf16_match * scale:
            raise AssertionError(f"bf16 kernel vs bf16 plain: {err:.3g} >= {bf16_match} * {scale:.3g}")
        f32_ref = run(pnp_ista_blocks, "float32")
        drift = float((got - f32_ref).abs().max())
        if not drift < BF16_DRIFT * float(f32_ref.abs().max()):
            raise AssertionError(f"bf16 kernel vs f32 plain: {drift:.3g} >= {BF16_DRIFT} * max|ref|")
        f32_gap = float((run(pnp_ista_blocks_fused, "float32") - ref).abs().max())
        if not f32_gap >= bf16_match * scale:
            raise AssertionError(f"the bf16 match cannot tell f32 operands: gap {f32_gap:.3g}")
        note = f" vs-f32-plain={drift:.3e} f32-kernel-gap={f32_gap:.3e}"
    plan = ISTA_KERNEL.plan(blocks.shape[0], blocks.shape[1], D.shape[1], matmul_dtype == "bfloat16")
    log(f"  nB={blocks.shape[0]:5d} {matmul_dtype:9s} max|delta|={err:.3e} "
        f"max|ref|={scale:.3e}{note} ok")
    log(f"        plan: {describe_plan(plan)}")
    return (err, scale) if with_scale else err


def long_k_problem():
    """nB 13, P 256, K 3000: random blocks and masks, a random unit-column
    dictionary (seed 3000) and trace4 alpha, on the card."""
    import numpy as np
    import torch

    from lrs_pnp_dip_tpu_torch.ops import compute_alpha
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    rng = np.random.default_rng(3000)
    D = rng.standard_normal((256, 3000)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    Y = rng.standard_normal((13, 256)).astype(np.float32)
    M = (rng.random((13, 256)) > 0.12).astype(np.float32)
    Y, M, D = (torch.from_numpy(a).cuda() for a in (Y, M, D))
    return Y, M, D, compute_alpha(D, M, SparseProxConfig(alpha_mode="trace4"))


def long_k_check(peaks: dict) -> dict:
    """The long-K tail at a short shape: B1's column tier once, f32 at P 256
    / K 3000 (past the streamed kernel's 1024 columns), nB 13, 20
    iterations (all of D[:, k_c] resident in clusters of 16), against its
    plain loop, a second launch with equal bits; timed (time_b1)."""
    import torch

    from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, pnp_ista_blocks, pnp_ista_blocks_fused
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    Y, M, D, alpha = long_k_problem()
    cfg = SparseProxConfig(n_iter=20)
    got = pnp_ista_blocks_fused(Y, M, D, cfg, alpha=alpha)
    again = pnp_ista_blocks_fused(Y, M, D, cfg, alpha=alpha)
    torch.cuda.synchronize()
    plan = ISTA_KERNEL.last_plan
    if plan.tier != "column":
        raise AssertionError(f"P 256, K 3000 took the {plan.tier} tier, not the column tier")
    if not torch.equal(got, again):
        raise AssertionError(f"column tier: two launches differ in {int((got != again).sum())} values")
    ref = pnp_ista_blocks(Y, M, D, cfg, alpha=alpha)
    torch.testing.assert_close(got, ref, **F32_TOL)
    t = time_b1(Y, M, D, alpha, "float32", peaks, n_iter=20)
    log(f"  column tier, f32, nB 13, P 256, K 3000, 20 iterations: max|delta|={float((got - ref).abs().max()):.3e} "
        f"from the plain loop, two launches give equal bits; kernel_ms={t['ms']:.4f} bound_ms={t['bound_ms']:.4f} "
        f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f}; plan: {describe_plan(plan)}")
    return dict(t, max_abs_err=float((got - ref).abs().max()), tier=plan.tier, waves=plan.waves,
                l2_bytes_per_iteration=plan.l2_bytes_per_iteration)


def long_k_shapes(peaks: dict, smi: str) -> dict:
    """B1's column tier at chip_smoke.LONG_K_SHAPES (nB 144, 100 iterations,
    trace4 alpha, random unit-column dictionaries): each against its plain
    loop (bf16 at the limit of bf16_limit, its max |delta| over max |ref|
    kept beside the limit and its two floors), equal bits on repeat, timed
    beside its bound, its plain loop and the 200 torch.matmul calls."""
    from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL

    out = {}
    for block, K, types in LONG_K_SHAPES:
        wide = wide_problem(block, K)
        floors = {}
        if "bfloat16" in types:
            limit, order, tc = bf16_limit(*wide, f"block {block} (P {block * block}), K {K}")
            floors = dict(order_sensitivity=order, tensor_core_sensitivity=tc, bf16_limit=limit)
        for mm in types:
            bf16 = mm == "bfloat16"
            err, scale = check_kernel(*wide, mm, bf16_match=floors.get("bf16_limit", BF16_MATCH), with_scale=True)
            check_same_bits(*wide, mm)
            t = time_b1(*wide, mm, peaks)
            plan = ISTA_KERNEL.plan(144, block * block, K, bf16)
            if plan.tier != "column":
                raise AssertionError(f"P {block * block}, K {K}, {mm}: tier {plan.tier}, not the column tier")
            out[f"P{block * block}_K{K}_{mm}"] = dict(
                t, max_abs_err=err, max_ref=scale, max_rel_err=err / scale, tier=plan.tier, waves=plan.waves,
                l2_bytes_per_iteration=plan.l2_bytes_per_iteration, **(floors if bf16 else {}))
            log(f"  {mm:9s} kernel_ms={t['ms']:.4f} bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) -> "
                f"{t['bound_ms'] / t['ms']:.1%} of bound; plain_ms={t['plain_ms']:.4f}; {2 * 100} {mm} "
                f"torch.matmul calls {t['library_ms']:.4f} ms; card {smi}")
    return out


def wide_tiles_of_16(peaks: dict, smi: str) -> dict:
    """The f32 streamed kernel with tiles of 16 block rows (more than 12 rows
    per cluster): at nB 240 the plan runs 16 rows per cluster in one wave of
    15 clusters of 8, at block 40 / K 512 (stages of 16 rows) and at P 1296
    / K 1024 (stages of 8).  Each is held to its plain loop with equal bits
    on repeat and timed beside the same inputs on 12 rows per cluster in
    two waves (tiles of 12), the tiling the plan would take if it did not
    count waves first."""
    import torch

    from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, pnp_ista_blocks, pnp_ista_blocks_fused
    from lrs_pnp_dip_tpu_torch.ops.ista_cuda import _MAX_SMEM_BYTES, _streamed_plan
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    out = {}
    for block, K in ((40, 512), (36, 1024)):
        wide = wide_problem(block, K, nB=240)
        P = block * block
        plan = ISTA_KERNEL.plan(240, P, K, False)
        if (plan.tier, plan.rows, plan.waves) != ("streamed", 16, 1):
            raise AssertionError(f"nB 240, P {P}, K {K}: {describe_plan(plan)}, not 16 rows in one wave")
        err = check_kernel(*wide, "float32")
        check_same_bits(*wide, "float32")
        t = time_b1(*wide, "float32", peaks)
        twelve = _streamed_plan(240, P, K, False, {8: 10, 16: 0}, _MAX_SMEM_BYTES, [])
        if twelve is None or twelve.rows != 12:
            raise AssertionError(f"nB 240, P {P}, K {K}: no tiling of 12 rows per cluster")
        cfg = SparseProxConfig(n_iter=100)
        with ISTA_KERNEL.forcing(twelve):
            got = pnp_ista_blocks_fused(*wide[:3], cfg, alpha=wide[3])
            t12 = time_cuda(lambda: pnp_ista_blocks_fused(*wide[:3], cfg, alpha=wide[3]), reps=5)
        torch.testing.assert_close(got, pnp_ista_blocks(*wide[:3], cfg, alpha=wide[3]), **F32_TOL)
        out[f"P{P}_K{K}_float32_nB240"] = dict(
            t, max_abs_err=err, tier=plan.tier, waves=plan.waves, rows=plan.rows,
            l2_bytes_per_iteration=plan.l2_bytes_per_iteration, rows12_two_waves_ms=t12)
        log(f"  nB 240, P {P}, K {K}, f32: 16 rows per cluster in one wave {t['ms']:.4f} ms, 12 rows in "
            f"{-(-twelve.n_clusters // plan.resident)} waves {t12:.4f} ms; bound_ms={t['bound_ms']:.4f}; "
            f"plain_ms={t['plain_ms']:.4f}; 200 torch.matmul calls {t['library_ms']:.4f} ms; card {smi}")
    return out


def tier_problem(nB: int, P: int, K: int, seed: int = 0):
    """Random blocks (nB, P), masks with 12% of the values missing and the
    second block wholly missing, a random (P, K) unit-column dictionary and
    trace4 alpha, on the card: B1's inputs at a shape of TIER_SHAPES."""
    import numpy as np
    import torch

    from lrs_pnp_dip_tpu_torch.ops import compute_alpha
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    rng = np.random.default_rng(seed)
    D = rng.standard_normal((P, K)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    Y = rng.standard_normal((nB, P)).astype(np.float32)
    M = (rng.random((nB, P)) > 0.12).astype(np.float32)
    M[1] = 0.0
    Y, M, D = (torch.from_numpy(a).cuda() for a in (Y, M, D))
    return Y, M, D, compute_alpha(D, M, SparseProxConfig(alpha_mode="trace4"))


def time_candidates(blocks, masks, D, alpha, cfg, plans, warmup: int = 2, reps: int = 7) -> list:
    """Median ms of one B1 launch under each of ``plans`` (one shape's
    candidates), timed in turns: ``warmup`` launches of each, then ``reps``
    rounds that time each once with CUDA events.  Returns each plan's
    median and all its times."""
    import torch

    from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, pnp_ista_blocks_fused

    for plan in plans:
        with ISTA_KERNEL.forcing(plan):
            for _ in range(warmup):
                pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha)
    times = [[] for _ in plans]
    for _ in range(reps):
        for plan, got in zip(plans, times):
            with ISTA_KERNEL.forcing(plan):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha)
                end.record()
                torch.cuda.synchronize()
                got.append(start.elapsed_time(end))
    return [(statistics.median(t), t) for t in times]


def tier_sweep(peaks: dict, smi: str) -> dict:
    """B1's tiers at TIER_SHAPES (tier_problem, 100 iterations, trace4
    alpha): every tiling of plan_candidates, forced in turn, against the
    plain loop (f32 at F32_TOL and within 1e-4 of max |ref|; bf16 at the
    limit of bf16_limit and within BF16_DRIFT of the f32 plain loop), two
    launches with equal bits; then all timed in turns (time_candidates),
    each logged beside its predicted time (which stays out of the returned
    entry: the kernels line carries measured times and the bound only), and
    the plan's pick beside the fastest.
    Fails on a candidate that misses the plain loop; a pick slower than the
    fastest is reported, not failed (timings move between calls)."""
    import torch

    from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, pnp_ista_blocks, pnp_ista_blocks_fused
    from lrs_pnp_dip_tpu_torch.ops.ista_cuda import _MAX_SMEM_BYTES, plan_candidates, predicted_ms
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    out = {}
    for nB, P, K, types in TIER_SHAPES:
        problem = tier_problem(nB, P, K)
        for mm in types:
            bf16 = mm == "bfloat16"
            cfg = SparseProxConfig(n_iter=100, matmul_dtype=mm)
            ref = pnp_ista_blocks(*problem[:3], cfg, alpha=problem[3])
            scale = float(ref.abs().max())
            if bf16:
                limit, _, _ = bf16_limit(*problem, f"nB {nB}, P {P}, K {K}")
                f32_ref = pnp_ista_blocks(*problem[:3], dataclasses.replace(cfg, matmul_dtype="float32"),
                                          alpha=problem[3])
            plans = plan_candidates(nB, P, K, bf16, ISTA_KERNEL.resident_clusters(bf16), _MAX_SMEM_BYTES)
            pick = ISTA_KERNEL.plan(nB, P, K, bf16)
            rows = []
            for plan in plans:
                with ISTA_KERNEL.forcing(plan):
                    got = pnp_ista_blocks_fused(*problem[:3], cfg, alpha=problem[3])
                    torch.matmul(problem[0], problem[2])  # other work in between
                    again = pnp_ista_blocks_fused(*problem[:3], cfg, alpha=problem[3])
                    torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                label = f"nB {nB}, P {P}, K {K}, {mm}, tier {plan.tier}"
                if not (torch.isfinite(got).all() and torch.equal(got, again)):
                    raise AssertionError(f"{label}: not finite, or two launches differ")
                if bf16:
                    drift = float((got - f32_ref).abs().max())
                    if not (err < limit * scale and drift < BF16_DRIFT * float(f32_ref.abs().max())):
                        raise AssertionError(f"{label}: {err:.3g} >= {limit:.3g} * {scale:.3g} or drift {drift:.3g}")
                else:
                    torch.testing.assert_close(got, ref, **F32_TOL)
                    if not err < 1e-4 * scale:
                        raise AssertionError(f"{label}: {err:.3g} >= 1e-4 * {scale:.3g}")
                rows.append(dict(tier=plan.tier, cluster_size=plan.cluster_size, rows=plan.rows, waves=plan.waves,
                                 l2_bytes_per_iteration=plan.l2_bytes_per_iteration, max_abs_err=err,
                                 pick=plan == pick))
            timed = time_candidates(*problem[:3], problem[3], cfg, plans)
            for plan, row, (ms, _) in zip(plans, rows, timed):
                row["ms"] = ms
                log(f"  nB {nB:5d} P {P:5d} K {K:5d} {mm:9s} {row['tier']:8s} C{row['cluster_size']:2d} "
                    f"R{row['rows']:2d} {row['waves']:2d} wave(s): {ms:.4f} ms (model's prediction "
                    f"{predicted_ms(plan):.4f}, not a measurement){' <- pick' if row['pick'] else ''}; "
                    f"max|delta|={row['max_abs_err']:.3e} of max|ref| {scale:.3e}, equal bits on repeat")
            pick_ms = next(r["ms"] for r in rows if r["pick"])
            fastest = min(r["ms"] for r in rows)
            b_ms, by, _, _ = bound_ms(nB, P, K, 100, mm, peaks)
            lib_ms = matmul_yardstick_ms(nB, problem[2], 100, mm)
            log(f"    pick {pick.tier} {pick_ms:.4f} ms, fastest {fastest:.4f} ms, ratio {pick_ms / fastest:.4f}; "
                f"bound_ms={b_ms:.4f} ({by}); 200 torch.matmul calls {lib_ms:.4f} ms; card {smi}")
            out[f"nB{nB}_P{P}_K{K}_{mm}"] = dict(
                candidates=rows, pick=pick.tier, pick_ms=pick_ms, fastest_ms=fastest, ratio=pick_ms / fastest,
                bound_ms=b_ms, bound_by=by, library_ms=lib_ms, max_ref=scale)
    return out


def describe_plan(plan) -> str:
    text = (f"tier {plan.tier}: {plan.n_clusters} clusters of {plan.cluster_size} CTAs ({plan.resident} "
            f"resident, {plan.waves} wave(s)), {plan.rows} rows per cluster, {plan.slice_rows} rows of D and "
            f"{plan.seg} columns of x per CTA, {plan.smem_bytes} B of shared memory")
    if plan.tier == "streamed":
        text += (f"; {plan.resident_rows} rows of each slice resident, {plan.streamed_rows} "
                 f"through a ring of {plan.stages} stages of {plan.stage_rows} rows")
    elif plan.tier == "column":
        text += (f"; {plan.resident_rows} of the {plan.P} rows of each CTA's columns resident, "
                 f"{plan.streamed_rows} read from L2 in each product")
    if plan.streamed:
        text += (f", {plan.scratch_floats * 4} B of scratch, {plan.l2_bytes_per_iteration} B of D through L2 per "
                 "cluster and iteration")
    return text


def check_same_bits(blocks, masks, D, alpha, matmul_dtype: str) -> None:
    """Two launches of kernel B1 on the same inputs must give equal bits:
    its reductions run in a fixed order, without atomics."""
    import torch

    from lrs_pnp_dip_tpu_torch.ops import pnp_ista_blocks_fused
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    cfg = SparseProxConfig(n_iter=100, matmul_dtype=matmul_dtype)
    first = pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha)
    # other work between the two launches, so that the second does not
    # find the card as the first left it
    torch.matmul(blocks, D)
    second = pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha)
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        differing = int((first != second).sum())
        raise AssertionError(f"two launches differ in {differing} of {first.numel()} values")
    log(f"  nB={blocks.shape[0]:5d} {matmul_dtype:9s} two launches give equal bits")


def order_sensitivity(blocks, masks, D, alpha, seeds=(0, 1)) -> float:
    """How far the bf16 plain loop moves, in max |delta| over max |ref|, when
    only the order of its sums changes (the rows of D permuted), on the
    card: one half of the floor under the bf16 limit (bf16_limit)."""
    import torch

    from lrs_pnp_dip_tpu_torch.ops import pnp_ista_blocks
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    cfg = SparseProxConfig(n_iter=100, matmul_dtype="bfloat16")
    ref = pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha)
    worst = 0.0
    for seed in seeds:
        perm = torch.randperm(D.shape[0], generator=torch.Generator().manual_seed(seed)).to(D.device)
        got = pnp_ista_blocks(blocks[:, perm], masks[:, perm], D[perm], cfg, alpha=alpha)
        worst = max(worst, float((got - ref).abs().max() / ref.abs().max()))
    return worst


def tensor_core_sensitivity(blocks, masks, D, alpha) -> float:
    """How far the bf16 plain loop moves, in max |delta| over max |ref|, when
    its products run on the tensor cores (TF32 takes the bf16-valued
    operands exactly and accumulates in f32, as the kernel's mma.sync does)
    in cuBLAS's order: the other half of the floor under the bf16 limit."""
    import torch

    from lrs_pnp_dip_tpu_torch.ops import pnp_ista_blocks
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    cfg = SparseProxConfig(n_iter=100, matmul_dtype="bfloat16")
    ref = pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        moved = pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return float((moved - ref).abs().max() / ref.abs().max())


def bf16_limit(blocks, masks, D, alpha, label: str) -> tuple:
    """The bf16 limit at a random-dictionary shape (BF16_ORDER_FACTOR) and
    its two floors; logs them beside the limit the order floor alone gives."""
    order = order_sensitivity(blocks, masks, D, alpha)
    tc = tensor_core_sensitivity(blocks, masks, D, alpha)
    limit = max(BF16_MATCH, BF16_ORDER_FACTOR * max(order, tc))
    log(f"  {label}: the bf16 plain loop moves {order:.3e} of max|ref| with the rows of D permuted, {tc:.3e} "
        f"with its products on the tensor cores; bf16 limit {limit:.3e} (the permuted rows alone: "
        f"{max(BF16_MATCH, BF16_ORDER_FACTOR * order):.3e})")
    return limit, order, tc


def time_b1(blocks, masks, D, alpha, matmul_dtype: str, peaks: dict, n_iter: int = 100) -> dict:
    """B1's time beside its bound, its plain loop and the 2 n_iter
    torch.matmul calls of its two products (a partial yardstick: no single
    PyTorch call computes the fused loop with its NLM), in ms."""
    from lrs_pnp_dip_tpu_torch.ops import pnp_ista_blocks, pnp_ista_blocks_fused
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

    nB, P = blocks.shape
    K = D.shape[1]
    cfg = SparseProxConfig(n_iter=n_iter, matmul_dtype=matmul_dtype)
    k_ms = time_cuda(lambda: pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha), reps=5)
    p_ms = time_cuda(lambda: pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha), warmup=1, reps=3)
    b_ms, by, _, _ = bound_ms(nB, P, K, n_iter, matmul_dtype, peaks)
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                library_ms=matmul_yardstick_ms(nB, D, n_iter, matmul_dtype))


def matmul_yardstick_ms(nB: int, D, n_iter: int, matmul_dtype: str) -> float:
    """The 2 n_iter torch.matmul calls of B1's two products at (nB, D's
    shape) with the operand type, in ms: a partial yardstick, since no
    single PyTorch call computes the fused loop with its NLM."""
    import torch

    dt = torch.float32 if matmul_dtype == "float32" else torch.bfloat16
    x = torch.zeros((nB, D.shape[1]), device="cuda", dtype=dt)
    r = torch.zeros((nB, D.shape[0]), device="cuda", dtype=dt)
    Dm = D.to(dt)

    def matmuls():
        for _ in range(n_iter):
            torch.matmul(x, Dm.T)
            torch.matmul(r, Dm)

    return time_cuda(matmuls)


def bound_ms(nB: int, P: int, K: int, n_iter: int, matmul_dtype: str, peaks: dict):
    """The least time the card could take for B1's work: the larger of
    its operations over the peak rate for the operand type and its bytes
    (each input read once, the output written once) over the memory rate.
    Returns (ms, "operations" or "bytes", flops, bytes)."""
    flops = 4 * nB * P * K * n_iter
    io_bytes = (2 * nB * P + P * K + nB + nB * K) * 4
    peak = peaks["f32_flops"] if matmul_dtype == "float32" else peaks["bf16_flops"]
    ops_ms, bytes_ms = flops / peak * 1e3, io_bytes / peaks["bytes_per_s"] * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", flops, io_bytes


def drive(label: str, fn, launches: int, nB: int, bf16: bool = False):
    """Run one path with B1's count set to 0 just before and read just
    after; returns (result, wall seconds).  Fails unless B1 was launched
    ``launches`` times, the last of them over ``nB`` blocks with the operand
    type given."""
    import torch

    from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL

    torch.cuda.synchronize()
    ISTA_KERNEL.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got, plan = ISTA_KERNEL.launches, ISTA_KERNEL.last_plan
    if got != launches:
        raise AssertionError(f"{label}: B1 launched {got} times, expected {launches}")
    if launches and (plan.nB, plan.bf16) != (nB, bf16):
        raise AssertionError(
            f"{label}: B1's last launch took nB={plan.nB}, bf16={plan.bf16}; "
            f"expected nB={nB}, bf16={bf16}")
    return out, wall


def run_fits(solver, n: int, host_stepped: bool):
    """``solver.run(n)`` with its DIP fits replayed, or stepped from the host
    (``OuterStages.fit_chunk`` None); returns (cube, history, the reads of
    the stop flag in each step's fit)."""
    if host_stepped:
        solver.stages.fit_chunk = None
    reads = []
    state, hist = solver.run(n, callback=lambda i, st, aux: reads.append(solver.stages.dip_fit.flag_reads))
    return solver.result_cube(state), hist, reads


def replay_turns(sample, D_np, cfg, cube, hist, smi) -> None:
    """Phase 4's turns: the 2 steps of ``inpaint(variant="dip")`` (``cube``,
    ``hist``) through ``Solver.run`` again from the same seed, each turn a
    new solver, its fits host-stepped, replayed, replayed, host-stepped.
    Every turn gives the cube bit for bit with the same ``dip_iters``; a
    replayed fit reads its stop flag once per FIT_CHUNK iterations, a
    host-stepped one after every iteration; and the warm (second) step is
    faster replayed than host-stepped in every turn."""
    import numpy as np
    import torch

    from lrs_pnp_dip_tpu_torch.solvers import FIT_CHUNK, Solver

    log("[solve] the same 2 steps through Solver.run in turns from the same seed, host-stepped fits against "
        f"replayed ones (FIT_CHUNK {FIT_CHUNK}): host, replayed, replayed, host; card {smi}")
    warm = {"host": [], "replayed": []}
    for mode in ("host", "replayed", "replayed", "host"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, h, reads = run_fits(Solver(sample, D_np, cfg), 2, host_stepped=mode == "host")
        wall = time.perf_counter() - t0
        iters = [int(v) for v in h["dip_iters"]]
        per_read = [n if mode == "host" else -(-n // FIT_CHUNK) for n in iters]
        same = np.array_equal(got, cube) and iters == [int(v) for v in hist["dip_iters"]]
        warm[mode].append(h["seconds"][1])
        log(f"  {mode:8s}: wall per step {[round(v, 4) for v in h['seconds']]} s ({wall:.2f} s in all), dip_iters "
            f"{iters}, stop-flag reads per fit {reads}; the cube {'equals' if same else 'differs from'} "
            "inpaint's bit for bit")
        if not same:
            raise AssertionError(f"{mode} fits: the cube or dip_iters {iters} differ from inpaint's "
                                 f"{[int(v) for v in hist['dip_iters']]}")
        if reads != per_read:
            raise AssertionError(f"{mode} fits read the stop flag {reads} times, expected {per_read}")
    log(f"  warm step: replayed {[round(v, 4) for v in warm['replayed']]} s, host-stepped "
        f"{[round(v, 4) for v in warm['host']]} s ({min(warm['host']) / max(warm['replayed']):.2f}x at the "
        "least)")
    if not max(warm["replayed"]) < min(warm["host"]):
        raise AssertionError("a replayed warm step was not faster than every host-stepped one")


def check_recovery(label: str, cube, shape, final_mpsnr: float, input_mpsnr: float) -> None:
    import numpy as np

    if cube.shape != shape or not np.isfinite(cube).all():
        raise AssertionError(f"{label}: the recovered cube is not a finite {shape} array")
    if not final_mpsnr > input_mpsnr:  # also fails on NaN
        raise AssertionError(f"{label}: final MPSNR {final_mpsnr:.4f} not above input {input_mpsnr:.4f}")


def relative_error(got, ref):
    """(max |delta| / max |ref|, relative L2) of two tensors or arrays."""
    import torch

    got, ref = torch.as_tensor(got).cpu().double(), torch.as_tensor(ref).cpu().double()
    d = got - ref
    return float(d.abs().max() / ref.abs().max()), float(d.norm() / ref.norm())


def native_checks(native, sample, scene) -> list:
    """The native host library against the port's torch functions: block
    extraction and scatter at blocks 36 and 24 (at most two terms per entry,
    so the sums are exact), tile extraction against numpy slicing, and the
    column NLM within NLM_MATCH.  Returns what failed."""
    import numpy as np
    import torch

    from lrs_pnp_dip_tpu_torch.data import tiles
    from lrs_pnp_dip_tpu_torch.ops import block_grid, extract_blocks, nlm_column_batch, scatter_blocks

    failures = []
    Y = torch.from_numpy(sample.noisy.reshape(1296, 128)).cuda()
    for bb in (36, 24):
        grid = block_grid((1296, 128), bb, bb)
        ours = native.extract_blocks(Y.cpu().numpy(), bb, bb)
        if not np.array_equal(ours, extract_blocks(Y, grid).cpu().numpy()):
            failures.append(f"native extract_blocks differs at block {bb}")
        im, wt = native.scatter_blocks(ours, (1296, 128), bb, bb)
        torch_im = scatter_blocks(torch.from_numpy(ours).cuda(), grid).cpu().numpy()
        if not (np.array_equal(im, torch_im) and np.array_equal(wt, grid.weight().numpy())):
            failures.append(f"native scatter_blocks differs at block {bb}")
    origins = tiles.tile_origins(72, 72, 36, 36)
    cut = native.extract_tiles(scene.noisy, origins, 36, 36)
    if not all(np.array_equal(t, scene.noisy[h0:h0 + 36, w0:w0 + 36]) for t, (h0, w0) in zip(cut, origins)):
        failures.append("native extract_tiles differs from numpy slicing")
    rng = np.random.default_rng(0)
    G = (0.3 * rng.standard_normal((324, 512))).astype(np.float32)
    h = rng.uniform(0.05, 0.5, 324).astype(np.float32)
    delta = float(np.abs(native.nlm_column_batch(G, h) - nlm_column_batch(
        torch.from_numpy(G).cuda(), torch.from_numpy(h).cuda()).cpu().numpy()).max())
    log(f"  extract_blocks / scatter_blocks (blocks 36 and 24) and extract_tiles: equal bits; "
        f"nlm_column_batch (324 x 512) max|delta| {delta:.3e} (limit {NLM_MATCH})")
    if not delta < NLM_MATCH:
        failures.append("native nlm_column_batch disagrees with the port's")
    return failures


def long_tail(port, sample, input_mpsnr, scene, scene_in, capped, by_path, smi, peaks) -> dict:
    """Phase 7 (module docstring).  Adds the driven paths' launches of B1 to
    ``by_path``; returns B1's times at the auto-dictionary shape."""
    import glob
    import os
    import tempfile

    import numpy as np
    import torch

    from lrs_pnp_dip_tpu_torch import native
    from lrs_pnp_dip_tpu_torch.api import _auto_dictionary
    from lrs_pnp_dip_tpu_torch.data import learn_dictionary, synthetic_sample
    from lrs_pnp_dip_tpu_torch.data.dictionary import _ista_code, _mod_step, column_normalize, extract_training_patches
    from lrs_pnp_dip_tpu_torch.models import dip_skip_128, get_net
    from lrs_pnp_dip_tpu_torch.ops import (
        ISTA_KERNEL, block_grid, compute_alpha, extract_blocks, mpsnr, nlm_column_batch, pnp_ista_blocks,
        pnp_ista_blocks_fused, scatter_blocks,
    )
    from lrs_pnp_dip_tpu_torch.solvers import FitConfig, Solver, fit, init_state
    from lrs_pnp_dip_tpu_torch.utils import get_noise
    from lrs_pnp_dip_tpu_torch.utils.checkpoint import SolverCheckpointer
    from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig, dip_preset, lrs_pnp_preset
    from lrs_pnp_dip_tpu_torch.utils.profiling import annotate, trace

    t_phase = time.perf_counter()
    auto = dict(block_size=24, stride=24)
    # what fails in the native library's checks is raised at the end of the
    # phase, so that one run shows the rest of the phase too
    native_failures = []
    try:
        native.LIBRARY.load()
        log(f"[long tail] native host library built and loaded from {native.LIBRARY.build()}")
    except native.NativeUnavailable as e:
        native_failures.append(f"the native host library does not build here: {e}")
        log(f"[long tail] {native_failures[-1]}")

    def learn(s):
        """The auto-dictionary of ``s`` at block 24, timed, with its branch."""
        patches, mask_patches = extract_training_patches([s.noisy], block_size=24, stride=1, masks=[s.mask])
        n_full = int((mask_patches.min(axis=0) > 0).sum())
        branch = "full" if n_full >= max(64, patches.shape[1] // 4) else "masked"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        D = _auto_dictionary(s, dip_preset(**auto))
        torch.cuda.synchronize()
        return D, branch, f"{n_full} of {patches.shape[1]} patches fully observed", time.perf_counter() - t0

    log("[long tail] the auto-dictionary at block_size 24 on synthetic_sample(36, 36, 128, seed=0)")
    D_auto, branch, counts, cold_s = learn(sample)
    _, _, _, warm_s = learn(sample)
    log(f"  learned ({branch} branch, {counts}): K={D_auto.shape[1]}, P={D_auto.shape[0]}; "
        f"{cold_s:.3f} s cold, {warm_s:.3f} s warm; card {smi}")
    if branch != "full" or D_auto.shape != (576, 512):
        raise AssertionError(f"expected the full branch and a (576, 512) dictionary, got {branch} {D_auto.shape}")
    holed = synthetic_sample(36, 36, 128, missing=0.2, seed=0)
    D_masked, branch, counts, masked_s = learn(holed)
    log(f"  missing=0.2: {branch} branch ({counts}), K={D_masked.shape[1]}, {masked_s:.3f} s")
    if branch != "masked" or not np.isfinite(D_masked).all():
        raise AssertionError(f"expected finite atoms from the masked branch, got {branch}")

    log(f"[long tail] inpaint(variant='dip', block_size=24, stride=24, n_iters=2) without dictionary=, "
        f"DIP fit capped at {DIP_CAP}")
    (cube, hist), wall = drive("auto-dictionary dip", lambda: port.inpaint(
        sample.noisy, sample.mask, variant="dip", clean=sample.clean, n_iters=2, **auto, **capped("dip")),
        launches=2, nB=324)
    plan = ISTA_KERNEL.last_plan
    by_path["dip, auto-dictionary"] = ISTA_KERNEL.launches
    if (plan.P, plan.K, plan.cluster_size) != (576, 512, 8):
        raise AssertionError(f"B1 took P={plan.P}, K={plan.K}, clusters of {plan.cluster_size}")
    check_recovery("auto-dictionary dip", cube, (36, 36, 128), hist["mpsnr"][-1], input_mpsnr)
    log(f"  wall {wall:.2f} s (learning included), mpsnr {input_mpsnr:.4f} -> "
        f"{[round(v, 4) for v in hist['mpsnr']]}, DIP iterations {[int(v) for v in hist['dip_iters']]}, "
        f"per step {[round(v, 3) for v in hist['seconds']]} s; B1 launches {ISTA_KERNEL.launches} "
        f"(nB {plan.nB}, P {plan.P}, K {plan.K}: {plan.n_clusters} clusters of {plan.cluster_size})")

    log("[long tail] learn_dictionary(n_outer=2) on the card against the CPU, from the same patches")
    patches, mask_patches = extract_training_patches([sample.noisy], block_size=24, stride=1, masks=[sample.mask])
    full = np.ascontiguousarray(patches[:, mask_patches.min(axis=0) > 0])
    kw = dict(n_atoms=512, n_outer=2, sparse_iters=20)
    times = {}
    learned = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learned[dev] = learn_dictionary(full, device=dev, **kw)
        times[dev] = time.perf_counter() - t0
    # the same two MOD steps on the card, from the same initial atoms, with
    # the patches in another order: only the order of the sums changes
    rng = np.random.default_rng(0)  # learn_dictionary's init, seed 0
    init_idx = rng.choice(full.shape[1], size=512, replace=full.shape[1] < 512)
    noise = rng.standard_normal((full.shape[0], 512)).astype(np.float32)
    D_shuffled = column_normalize(torch.from_numpy(full[:, init_idx] + 1e-3 * noise).cuda())
    Y_shuffled = torch.from_numpy(full[:, np.random.default_rng(1).permutation(full.shape[1])]).cuda()
    for _ in range(kw["n_outer"]):
        D_shuffled = _mod_step(Y_shuffled, D_shuffled, 0.05, kw["sparse_iters"])
    shuffled = D_shuffled.cpu().numpy()

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def recon(D):
        Yc = torch.from_numpy(full).cuda()
        Dc = torch.from_numpy(D).cuda()
        Z = _ista_code(Yc, Dc, 0.05, 20)
        return float(torch.linalg.vector_norm(Dc @ Z - Yc) / torch.linalg.vector_norm(Yc))

    rel = rel_l2(learned["cuda"], learned["cpu"])
    order = rel_l2(shuffled, learned["cuda"])
    limit = max(LEARN_MATCH, 4 * order)
    errs = [recon(learned[dev]) for dev in ("cuda", "cpu")]
    log(f"  {full.shape[1]} patches of {full.shape[0]}, K 512: card {times['cuda']:.3f} s, CPU {times['cpu']:.3f} s; "
        f"relative L2 {rel:.3e} (the card's own, patches in another order: {order:.3e}; limit {limit:.3e}); "
        f"coding error card {errs[0]:.5f}, CPU {errs[1]:.5f} (limit {LEARN_RECON} apart, relative)")
    if not (rel < limit and abs(errs[0] - errs[1]) < LEARN_RECON * errs[1]):
        raise AssertionError("the card's learning disagrees with the CPU's")

    log("[long tail] B1 against the plain loop at the auto-dictionary's tiling: nB 324, P 576")
    blocks, masks, D, alpha = problem(36, 36, 0, D_auto, block_size=24)
    if blocks.shape != (324, 576):
        raise AssertionError(f"expected 324 blocks of 576, got {tuple(blocks.shape)}")
    dip_sparse = dip_preset().sparse
    for K in (512, 196, 200):
        D_k = D[:, :K].contiguous()
        alpha_k = alpha if K == 512 else compute_alpha(D_k, masks, dip_sparse)
        for mm in ("float32", "bfloat16"):
            check_kernel(blocks, masks, D_k, alpha_k, mm)
            segs = ISTA_KERNEL.plan(324, 576, K, mm == "bfloat16").k_segments()
            log(f"        last CTA's columns {segs[-1]} (halo 4)")
    for mm in ("float32", "bfloat16"):
        check_same_bits(blocks, masks, D, alpha, mm)
    n_iter = 100
    x = torch.zeros((324, 512), device="cuda")
    r = torch.zeros((324, 576), device="cuda")
    timing = {}
    for mm in ("float32", "bfloat16"):
        cfg = SparseProxConfig(n_iter=n_iter, matmul_dtype=mm)
        k_ms = time_cuda(lambda: pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha))
        p_ms = time_cuda(lambda: pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha), reps=3)
        xo, ro, Do = (t.to(torch.bfloat16) for t in (x, r, D)) if mm == "bfloat16" else (x, r, D)

        def matmuls():
            for _ in range(n_iter):
                torch.matmul(xo, Do.T)
                torch.matmul(ro, Do)

        lib_ms = time_cuda(matmuls)
        b_ms, by, flops, io_bytes = bound_ms(324, 576, 512, n_iter, mm, peaks)
        timing[mm] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by, library_ms=lib_ms)
        log(f"  {mm:9s} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({by}, {flops:.3e} flops) "
            f"-> {b_ms / k_ms:.1%} of bound; {2 * n_iter} {mm} torch.matmul calls {lib_ms:.4f} ms; card {smi}")

    log("[long tail] inpaint_scene(variant='lrs_pnp', block_size=24, stride=24, tile_batch=4) without "
        "dictionary= on the 72x72x128 scene")
    native_calls = []
    real_extract = native.extract_tiles

    def counted_extract(*args):
        native_calls.append(len(args[1]))
        return real_extract(*args)

    native.extract_tiles = counted_extract  # the extractor a TileLoader takes when it is built
    try:
        rec, wall = drive("auto-dictionary scene", lambda: port.inpaint_scene(
            scene.noisy, scene.mask, variant="lrs_pnp", tile_batch=4, **auto), launches=2, nB=4 * 324)
    finally:
        native.extract_tiles = real_extract
    by_path["inpaint_scene, auto-dictionary"] = ISTA_KERNEL.launches
    scene_out = float(mpsnr(torch.from_numpy(scene.clean), torch.from_numpy(rec)))
    check_recovery("auto-dictionary scene", rec, (72, 72, 128), scene_out, scene_in)
    log(f"  wall {wall:.2f} s (learning included), mpsnr {scene_in:.4f} -> {scene_out:.4f}, B1 launches "
        f"{ISTA_KERNEL.launches} (nB {ISTA_KERNEL.last_plan.nB}); tiles cut by the native library: {native_calls}")
    if native_calls != [4]:
        native_failures.append(f"the scene's TileLoader did not take the native extractor once: {native_calls}")

    log("[long tail] checkpoint and resume")
    lrs_solver = Solver(sample, D_auto, lrs_pnp_preset(**auto))
    st1, _ = lrs_solver.step(lrs_solver.init_state())
    st2, _ = lrs_solver.step(st1)
    with tempfile.TemporaryDirectory() as ck_dir:
        ck = SolverCheckpointer(ck_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(int(st1.itr), st1)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = ck.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(ck_dir, "step_1.pt"))
        resumed, _ = lrs_solver.step(restored)
        same = torch.equal(resumed.X, st2.X) and torch.equal(resumed.lambda1, st2.lambda1)
        err = float((resumed.X - st2.X).abs().max() / st2.X.abs().max())
        log(f"  lrs_pnp: save {save_s * 1e3:.2f} ms, restore {restore_s * 1e3:.2f} ms, {size} bytes; resumed "
            f"step 2 {'equals' if same else 'differs from'} the uninterrupted one "
            f"(max|dX|/max|X| = {err:.3e}, limit {RESUME_MATCH})")
        if not (same or err <= RESUME_MATCH):
            raise AssertionError("the resumed lrs_pnp step disagrees with the uninterrupted one")
        state = init_state(sample, seed=0)
        ck.save(0, state)
        restored = ck.restore(0)
        net = dip_skip_128(num_channels=128).cuda()
        inits = []
        for gen in (state.generator, restored.generator):
            net.reset_parameters(gen)
            inits.append({k: v.clone() for k, v in net.state_dict().items()})
        if restored.generator.device.type != "cuda" or not all(
                torch.equal(inits[0][k], inits[1][k]) for k in inits[0]):
            raise AssertionError("the restored generator draws another DIP init")
        log(f"  dip: the restored CUDA generator draws the same first skip-128 init, "
            f"{sum(v.numel() for v in inits[0].values())} values, equal bits")

    log("[long tail] fit(get_net('skip')) on the 36x36x128 target: adam (find_best), sgd (lr decay), lbfgs")
    g = torch.Generator(device="cuda").manual_seed(0)
    net = get_net(32, "skip", pad="reflection", n_channels=128)
    inp = get_noise(g, 32, (36, 36))
    for cfg in (FitConfig(num_iter=20, lr=0.01),
                FitConfig(num_iter=20, lr=0.01, optimizer="sgd", lr_decay_epoch=5),
                FitConfig(num_iter=5, optimizer="lbfgs")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit(net, g, inp, sample.noisy[None], mask=sample.mask[None, :, :, None], config=cfg)
        torch.cuda.synchronize()
        losses = res.losses.cpu()
        log(f"  {cfg.optimizer:5s} {cfg.num_iter} steps {time.perf_counter() - t0:.2f} s: loss "
            f"{float(losses[0]):.5f} -> {float(losses[-1]):.5f}")
        if not (bool(torch.isfinite(losses).all()) and bool(torch.isfinite(res.out).all())
                and float(losses[-1]) < float(losses[0])):
            raise AssertionError(f"fit with {cfg.optimizer}: non-finite or no fall in the loss")

    log("[long tail] the native host library against the port's torch functions")
    if not native_failures:
        native_failures.extend(native_checks(native, sample, scene))

    log("[long tail] one warm lrs_pnp outer step under utils.profiling.trace")
    with tempfile.TemporaryDirectory() as trace_dir:
        with trace(trace_dir):
            with annotate("lrs_pnp_outer_step"):
                lrs_solver.step(st1)
        (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
        text = open(path).read()
    names = ("pnp_ista_cluster_f32", "lrs_pnp_outer_step")
    log(f"  Chrome trace {len(text)} bytes; names {', '.join(f'{n}: {n in text}' for n in names)}")
    if not all(n in text for n in names):
        raise AssertionError("the trace does not name B1's kernel and the annotation")
    log(f"  (long-tail phase {time.perf_counter() - t_phase:.1f} s)")
    if native_failures:
        raise AssertionError("; ".join(native_failures))
    return timing


def parallel_phase(sample, input_mpsnr, D_np, by_path, peaks) -> dict:
    """Phase 8 (module docstring).  Adds the ranks' launches of B1 to
    ``by_path``; returns B1's times at nB 72, one rank's share of the main
    shape."""
    import numpy as np
    import torch

    from lrs_pnp_dip_tpu_torch import inpaint
    from lrs_pnp_dip_tpu_torch.data import synthetic_sample
    from lrs_pnp_dip_tpu_torch.models import dip_skip_128
    from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, pnp_ista_blocks, pnp_ista_blocks_fused, sparse_prox
    from lrs_pnp_dip_tpu_torch.parallel.launch import spawn
    from lrs_pnp_dip_tpu_torch.parallel.workers import run_cases
    from lrs_pnp_dip_tpu_torch.solvers import FIT_CHUNK, BatchedSolver, Solver
    from lrs_pnp_dip_tpu_torch.utils.config import PRESETS, SparseProxConfig

    t_phase = time.perf_counter()
    blocks, masks, D, alpha = problem(36, 36, 0, D_np)
    host = [t.cpu().numpy() for t in (blocks, masks, D, alpha)]
    prox_inputs = [(mm, nB) for mm in ("float32", "bfloat16") for nB in (144, 13)]
    cases = [("prox_case", dict(
        axis_sizes={"patch": 2}, blocks=host[0][:nB], mask=host[1][:nB], D=host[2],
        cfg=SparseProxConfig(n_iter=100, matmul_dtype=mm), alpha=host[3][:nB],
    )) for mm, nB in prox_inputs]
    lrs = PRESETS["lrs_pnp"]()
    dip = PRESETS["dip"]()
    dip = dataclasses.replace(dip, dip=dataclasses.replace(dip.dip, num_iter=TP_DIP_CAP, learning_rate=TP_LR))
    lanes = [synthetic_sample(36, 36, 128, seed=k) for k in (0, 1)]
    init_net = dip_skip_128(128)
    init_net.reset_parameters(torch.Generator().manual_seed(1))
    dip_init = {k: v.clone() for k, v in init_net.state_dict().items()}
    dip_in, dip_mask = sample.noisy[None], sample.mask[None, :, :, None]
    cases += [
        ("solver_case", dict(axis_sizes={"patch": 2}, samples=sample, dictionary=D_np, config=lrs, n_steps=2)),
        ("solver_case", dict(axis_sizes={"data": 2}, samples=lanes, dictionary=D_np, config=lrs, n_steps=2)),
        ("solver_case", dict(axis_sizes={"model": 2}, samples=sample, dictionary=D_np, config=dip, n_steps=1,
                             dip_inits=[dip_init])),
        ("dryrun_case", {}),
    ]
    tp_first_step = [("tp_case", dict(
        axis_sizes={"model": 2}, net_spec=("dip_skip_128", dict(num_channels=128)), x=dip_in, target=dip_in,
        mask=dip_mask, seed=1, lr=0.1, n_steps=1, cudnn_benchmark=benchmark,
    )) for benchmark in (False, True)]
    cases.append(tp_first_step[0])
    dip_capped = PRESETS["dip"]()
    dip_capped = dataclasses.replace(dip_capped, dip=dataclasses.replace(dip_capped.dip, num_iter=DIP_CAP))
    for axes, samples in (({"patch": 2}, sample), ({"data": 2}, lanes)):
        for host_stepped in (False, True):
            cases.append(("solver_case", dict(axis_sizes=axes, samples=samples, dictionary=D_np, config=dip_capped,
                                              n_steps=2, host_stepped=host_stepped)))
    log("[parallel] 2 ranks on the one card over gloo: the {patch: 2} sparse prox, ShardedSolver on "
        "{patch: 2} (lrs_pnp; dip), {data: 2} (lrs_pnp, 2 lanes; dip, 2 lanes), {model: 2} (dip, skip-128 "
        f"channel TP, DIP capped at {TP_DIP_CAP}) and the dryrun; the dip cases capped at {DIP_CAP}, each with "
        "its fits replayed and host-stepped")
    t0 = time.perf_counter()
    two = spawn(run_cases, 2, args=("cuda", cases), device="cuda", timeout_s=SPAWN_TIMEOUT)
    log(f"  2-rank spawn {time.perf_counter() - t0:.1f} s (start-up of the ranks included)")
    # in fresh ranks: cuDNN keeps the algorithm it chose for a shape, also
    # when autotuning is turned on later in the process
    tuned = spawn(run_cases, 2, args=("cuda", tp_first_step[1:]), device="cuda", timeout_s=SPAWN_TIMEOUT)
    log("[parallel] 4 ranks: ShardedSolver on {patch: 2, band: 2}, one lrs_pnp step")
    t0 = time.perf_counter()
    four = spawn(run_cases, 4, args=("cuda", [("solver_case", dict(
        axis_sizes={"patch": 2, "band": 2}, samples=sample, dictionary=D_np, config=lrs, n_steps=1,
    ))]), device="cuda", timeout_s=SPAWN_TIMEOUT)
    log(f"  4-rank spawn {time.perf_counter() - t0:.1f} s")
    for ranks in (two, four):
        for r in ranks:
            for res in r:
                if "device" in res and (res["device"] != "cuda:0" or any(res["tf32"])):
                    raise AssertionError(f"a rank ran on {res['device']} with TF32 {res['tf32']}")

    # (a) the sharded sparse prox: one launch per rank; the gathered coefficients,
    # reconstructed once, equal one launch over all rows bit for bit
    for i, (mm, nB) in enumerate(prox_inputs):
        cfg = SparseProxConfig(n_iter=100, matmul_dtype=mm)
        ref = sparse_prox(blocks[:nB], masks[:nB], D, cfg, alpha=alpha[:nB]).cpu().numpy()
        got = [r[i] for r in two]
        per_rank = [(g["launches"], g["nB"]) for g in got]
        if per_rank != [(1, -(-nB // 2))] * 2:
            raise AssertionError(f"sharded prox nB {nB} {mm}: (launches, nB) per rank {per_rank}")
        for g in got:
            if not np.array_equal(g["out"], ref):
                raise AssertionError(f"sharded prox nB {nB} {mm}: max|delta| {np.abs(g['out'] - ref).max():.3e}"
                                     " against one launch over all rows")
        by_path[f"parallel_prox_patch2_{mm}_nB{nB}"] = sum(g["launches"] for g in got)
        log(f"  (a) {{patch: 2}} prox nB={nB:3d} {mm:9s}: B1 once per rank at nB {got[0]['nB']}, the result "
            f"equals one launch over all rows bit for bit; {got[0]['bytes']} B gathered per rank, "
            f"{got[0]['seconds'] * 1e3:.2f} ms per call")

    def per_step(ranks, k, label, launches, nB):
        steps = [r[k]["steps"] for r in ranks]
        for rank, st in enumerate(steps):
            got = [(s["launches"], s["nB"]) for s in st]
            if got != [(launches, nB if launches else None)] * len(st):
                raise AssertionError(f"{label}: rank {rank} (launches, nB) per step {got}")
        by_path[f"parallel_{label}"] = sum(s["launches"] for st in steps for s in st)
        for i, s in enumerate(steps[0]):
            log(f"  {label} step {i}: mpsnr={np.ravel(s['mpsnr']).round(4).tolist()} wall {s['seconds']:.3f} s, "
                f"B1 {s['launches']} per rank (nB {s['nB']}), {s['bytes']} B moved per rank")
        return ranks[0][k]

    # (b) {patch: 2}, the whole lrs_pnp preset
    got = per_step(two, 4, "patch2_lrs_pnp", 1, 72)
    one = Solver(sample, D_np, lrs, device="cuda")
    st, hist = one.run()
    X = st.X.cpu().numpy()
    err, scale = float(np.abs(got["X"] - X).max()), float(np.abs(X).max())
    log(f"  (b) {{patch: 2}} lrs_pnp: max|dX|={err:.3e} of max|X| {scale:.3e} ({err / scale:.2e}; limit "
        f"{SHARD_MATCH}) against the one-process solve; mpsnr {float(got['steps'][-1]['mpsnr']):.4f} "
        f"(one process {hist['mpsnr'][-1]:.4f}, input {input_mpsnr:.4f})")
    if not err <= SHARD_MATCH * scale or not float(got["steps"][-1]["mpsnr"]) > input_mpsnr:
        raise AssertionError("the {patch: 2} solve disagrees with the one-process solve")

    # (c) {patch: 2, band: 2}, one step, no launch of B1
    got = per_step(four, 0, "patch2_band2_lrs_pnp", 0, None)
    st1, _ = one.step(one.init_state())
    X1 = st1.X.cpu().numpy()
    err, scale = float(np.abs(got["X"] - X1).max()), float(np.abs(X1).max())
    log(f"  (c) {{patch: 2, band: 2}} one lrs_pnp step: max|dX|={err:.3e} ({err / scale:.2e} of max|X|)")
    if not err <= SHARD_MATCH * scale:
        raise AssertionError("the {patch: 2, band: 2} step disagrees with the one-process step")

    # (d) {data: 2}: a lane per rank
    got = per_step(two, 5, "data2_lrs_pnp", 1, 144)
    bst, _ = BatchedSolver(lanes, D_np, lrs, device="cuda").run()
    XB = bst.X.cpu().numpy()
    err, scale = float(np.abs(got["X"] - XB).max()), float(np.abs(XB).max())
    log(f"  (d) {{data: 2}} lanes against the one-process BatchedSolver: max|dX|={err:.3e} "
        f"({err / scale:.2e} of the scale; limit {LANES_MATCH})")
    if got["X"].shape != XB.shape or not err <= LANES_MATCH * scale:
        raise AssertionError("the {data: 2} lanes disagree with the BatchedSolver")

    # (b) and (d) with dip: the fit on the root of {patch: 2}, a lane's fit
    # per rank on {data: 2}; replayed, as in one process, against host-stepped
    for k, axes, label, nB in ((9, "{patch: 2}", "patch2_dip", 72), (11, "{data: 2}", "data2_dip", 144)):
        per_step(two, k, label, 1, nB)
        per_step(two, k + 1, label + "_host_stepped", 1, nB)
        for rank, r in enumerate(two):
            rep, host = r[k], r[k + 1]
            reads = [s["fit_reads"] for s in rep["steps"]]
            host_reads = [s["fit_reads"] for s in host["steps"]]
            iters = [int(np.sum(s["dip_iters"])) for s in rep["steps"]]
            fits_here = rank == 0 or label == "data2_dip"
            expected = [-(-n // FIT_CHUNK) for n in iters] if fits_here else [0, 0]
            same = np.array_equal(rep["X"], host["X"]) and iters == [int(np.sum(s["dip_iters"])) for s in host["steps"]]
            log(f"  ({'b' if k == 9 else 'd'}) {axes} dip, rank {rank}: dip_iters {iters}, stop-flag reads per "
                f"fit replayed {reads} (host-stepped {host_reads}), the fit "
                f"{'chunked on this rank' if fits_here else 'on the root, broadcast here'}; X "
                f"{'equals' if same else 'differs from'} the host-stepped fits' bit for bit")
            if not same or reads != expected or host_reads != (iters if fits_here else [0, 0]):
                raise AssertionError(f"{axes} dip on rank {rank}: the replayed fits differ from the host-stepped "
                                     f"ones, or read the flag {reads} times (expected {expected})")

    # (e) {model: 2}: channel TP of skip-128 in the DIP fit
    def rel_l2(a, b):
        return float(np.sqrt(sum(np.sum((x - y) ** 2) for x, y in zip(a, b)) / sum(np.sum(y ** 2) for y in b)))

    for ranks, autotuned in (([r[0] for r in tuned], True), ([r[8] for r in two], False)):
        for rank, tp in enumerate(ranks):
            ours, ref, _, g64 = zip(*tp["grads"].values())
            e_tp, e_ref = rel_l2(ours, g64), rel_l2(ref, g64)
            limit = max(TP_ORDER * e_ref, TP_GRAD_REL)
            log(f"  (e) {{model: 2}} skip-128 at 36x36x128, first step, rank {rank}, cuDNN "
                f"{'autotuned' if autotuned else 'by heuristics'}: the {len(ours)} gradients on its slices "
                f"{e_tp:.3e} (relative L2) from f64, the unsharded f32 ones {e_ref:.3e}"
                + (f" (limit {limit:.3e})" if autotuned else " (reported)")
                + f"; forward max|d| {np.abs(tp['out_tp'] - tp['out_ref']).max():.3e}, loss "
                f"{tp['tp_losses'][0]:.6f} against {tp['ref_losses'][0]:.6f}")
            if autotuned and not e_tp <= limit:
                raise AssertionError(f"TP gradient on rank {rank}: {e_tp:.3e} from f64, limit {limit:.3e}")
            if not np.allclose(tp["out_tp"], tp["out_ref"], atol=TP_OUT_ATOL, rtol=TP_OUT_RTOL):
                raise AssertionError(f"TP forward on rank {rank}: max|d| {np.abs(tp['out_tp'] - tp['out_ref']).max():.3e}")
    log(f"      {two[0][8]['report']['n_shards']}-way split of {len(two[0][8]['report']['sharded'])} tensors, "
        f"{len(two[0][8]['report']['indivisible_convs'])} kernels left whole")
    got = per_step(two, 6, "model2_dip", 1, 144)
    runs = {}
    for dev in ("cuda", "cpu"):
        solver = Solver(sample, D_np, dip, device=dev, dip_init=lambda itr: dip_init)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, aux = solver.step(solver.init_state())
        torch.cuda.synchronize()
        runs[dev] = dict(X=st.X.cpu().numpy(), phi=aux.phi_scatter.cpu().numpy(), dip_loss=float(aux.dip_loss),
                         mpsnr=float(aux.mpsnr), iters=aux.dip_iters, seconds=time.perf_counter() - t0)
    s = got["steps"][0]
    if s["fit_reads"] != s["dip_iters"]:
        raise AssertionError(f"{{model: 2}}: the TP fit read its stop flag {s['fit_reads']} times in "
                             f"{s['dip_iters']} iterations; it is host-stepped")
    log(f"  (e) {{model: 2}}: the TP fit host-stepped by the mesh's choice (gloo collectives cannot be captured): "
        f"{s['fit_reads']} stop-flag reads in {s['dip_iters']} iterations")
    tp_run = dict(X=got["X"], dip_loss=float(s["dip_loss"]), mpsnr=float(np.ravel(s["mpsnr"])[0]))

    def gaps(a, b):
        return dict(X=float(np.abs(a["X"] - b["X"]).max()), dip_loss=abs(a["dip_loss"] - b["dip_loss"]) / b["dip_loss"],
                    mpsnr=abs(a["mpsnr"] - b["mpsnr"]) / b["mpsnr"])

    tp_gap, order_gap = gaps(tp_run, runs["cuda"]), gaps(runs["cpu"], runs["cuda"])
    bounds = dict(X=TP_X_ATOL, dip_loss=TP_LOSS_RTOL, mpsnr=TP_MPSNR_RTOL)
    limits = {k: max(bounds[k], TP_ORDER * order_gap[k]) for k in bounds}
    phi_gap = float(np.abs(s["phi_scatter"] - runs["cuda"]["phi"]).max())
    log(f"  (e) {{model: 2}} dip step from one init, DIP capped at {TP_DIP_CAP}, lr {TP_LR}: dip_iters "
        f"{s['dip_iters']} (one process {runs['cuda']['iters']}, on the CPU {runs['cpu']['iters']}); phi_scatter "
        f"max|d| {phi_gap:.3e} (limit {TP_PHI_ATOL}); " + ", ".join(
            f"{k} TP {tp_gap[k]:.3e}, card against CPU {order_gap[k]:.3e} (limit {limits[k]:.3e})" for k in bounds))
    log(f"      ms per DIP iteration: TP over 2 ranks {s['seconds'] * 1e3 / max(s['dip_iters'], 1):.3f}, "
        f"one process {runs['cuda']['seconds'] * 1e3 / max(runs['cuda']['iters'], 1):.3f} (first use of the "
        "shapes included in both; two ranks time-share one card and gloo stages through the host: overhead, "
        "not scaling)")
    if not phi_gap <= TP_PHI_ATOL or any(not tp_gap[k] <= limits[k] for k in bounds):
        raise AssertionError("the {model: 2} dip step disagrees with the one-process step")

    # (f) the dryrun
    got = [r[7] for r in two]
    diff = float(np.abs(got[0]["X"] - got[0]["X_local"]).max())
    log(f"  (f) multiprocess_dryrun, 2 ranks on {{patch: 1, band: 2}}: max|X_sharded-X_local|={diff:.2e} "
        f"(limit 5e-4), mpsnr {got[0]['mpsnr']:.3f}")
    if not diff < 5e-4 or not np.array_equal(got[0]["X"], got[1]["X"]):
        raise AssertionError("the dryrun diverged")

    # (g) C1: block 40 in this process, on B1's streamed kernel
    log("[parallel] C1: inpaint(variant='lrs_pnp', block_size=40, stride=40) on the card, the default backend "
        "against backend='xla'")
    (cube, hist), wall = drive("block40", lambda: inpaint(
        sample.noisy, sample.mask, variant="lrs_pnp", clean=sample.clean, block_size=40, stride=40),
        launches=2, nB=132)
    plan = ISTA_KERNEL.last_plan
    by_path["lrs_pnp_block40"] = ISTA_KERNEL.launches
    if not plan.streamed or plan.P != 1600:
        raise AssertionError(f"block 40 took B1 at P {plan.P}, streamed {plan.streamed}")
    check_recovery("block40", cube, (36, 36, 128), hist["mpsnr"][-1], input_mpsnr)
    xla = dataclasses.replace(lrs.sparse, backend="xla")
    (cube_xla, hist_xla), wall_xla = drive("block40_xla", lambda: inpaint(
        sample.noisy, sample.mask, variant="lrs_pnp", clean=sample.clean, block_size=40, stride=40,
        sparse=xla), launches=0, nB=0)
    err, _ = relative_error(cube, cube_xla)
    log(f"  default backend: B1 {by_path['lrs_pnp_block40']} launches in 2 steps (nB "
        f"{plan.nB}, P {plan.P}, K {plan.K}: {describe_plan(plan)}), mpsnr {hist['mpsnr'][-1]:.4f}, wall {wall:.2f} "
        f"s; backend='xla': mpsnr {hist_xla['mpsnr'][-1]:.4f}, wall {wall_xla:.2f} s (learning included in "
        f"both); max|dX|/max|X| = {err:.3e} (limit {SOLVE_MATCH}: B1 against the plain loop, the only change)")
    if not err < SOLVE_MATCH:
        raise AssertionError("block 40: B1's solve disagrees with backend='xla'")
    log("[parallel] a shape past the TPU kernel's range: block 54 (P 2916), K 512, f32")
    rng = np.random.default_rng(0)
    past = [torch.from_numpy(rng.random(shape, dtype=np.float32)).cuda() for shape in ((4, 2916), (4, 2916), (2916, 512))]
    try:
        sparse_prox(*past, SparseProxConfig(n_iter=2))
    except ValueError as e:
        if 'backend="xla"' not in str(e):
            raise
        log(f"  raises: {e}")
    else:
        raise AssertionError("block 54 did not raise the plan's ValueError")

    # B1 at one rank's share of the main shape
    timing = {}
    for mm in ("float32", "bfloat16"):
        cfg = SparseProxConfig(n_iter=100, matmul_dtype=mm)
        args = (blocks[:72], masks[:72], D, cfg)
        k_ms = time_cuda(lambda: pnp_ista_blocks_fused(*args, alpha=alpha[:72]))
        p_ms = time_cuda(lambda: pnp_ista_blocks(*args, alpha=alpha[:72]), reps=3)
        b_ms, by, _, _ = bound_ms(72, blocks.shape[1], D.shape[1], 100, mm, peaks)
        plan = ISTA_KERNEL.plan(72, blocks.shape[1], D.shape[1], mm == "bfloat16")
        timing[mm] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by)
        log(f"[timing] B1 at nB=72 (one rank's share) {mm:9s}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({by}) -> {b_ms / k_ms:.1%} of bound; {plan.n_clusters} clusters of "
            f"{plan.cluster_size}, {plan.rows} rows each")
    log(f"  (parallel phase {time.perf_counter() - t_phase:.1f} s)")
    return timing


def profile_window(fn, units: int) -> dict:
    """One run of ``fn`` under torch.profiler: wall ms, kernels on the card,
    launches the host made (kernels and graphs) and the device's busy share
    (the union of the kernels' intervals over the wall time), each per unit;
    then the host's syncs per unit, counted by torch's sync debug mode in a
    second run."""
    import warnings

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    kernels = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    launches = [e for e in events if e.name.startswith(("cudaLaunchKernel", "cudaGraphLaunch", "cuLaunchKernel"))]
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return dict(
        ms=wall_us / 1e3 / units, kernels=len(kernels) / units, host_launches=len(launches) / units,
        busy=busy_us / wall_us, syncs=syncs / units,
    )


def fmt_profile(p: dict) -> str:
    return (f"{p['ms']:.3f} ms, {p['kernels']:.1f} kernels, {p['host_launches']:.1f} host launches, "
            f"{p['syncs']:.2f} host syncs, device busy {p['busy']:.1%}")


def _load_script(name: str):
    """A module of scripts/ beside this file."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def scanned_phase(port, sample, input_mpsnr, D_np, scene, by_path, smi, peaks, dip_first) -> dict:
    """Phase 9 (module docstring).  Adds the scanned paths' launches of B1 to
    ``by_path``; returns the yardstick times at the engines' and the ranks'
    shapes."""
    import numpy as np
    import torch

    from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, pnp_ista_blocks, pnp_ista_blocks_fused
    from lrs_pnp_dip_tpu_torch.solvers import FIT_CHUNK, DipFit, SeedEnsembleSolver, Solver
    from lrs_pnp_dip_tpu_torch.solvers.admm import default_net
    from lrs_pnp_dip_tpu_torch.solvers.graphs import Captured
    from lrs_pnp_dip_tpu_torch.utils.config import PRESETS, SparseProxConfig

    t_phase = time.perf_counter()
    log("[scanned] kernel B1 launched from a captured graph against an eager launch, nB 144, f32 and bf16, "
        "on the streamed kernel (block 40, K 512, f32; P 1296, K 1024, bf16) and on the column kernel "
        "(P 1296, K 1152, f32; P 576, K 2048, bf16; P 576, K 1152, f32 and bf16, moved there by the plan's timings)")
    blocks, masks, D, alpha = problem(36, 36, 0, D_np)
    for mm, inputs, tier in (("float32", None, "resident"), ("bfloat16", None, "resident"),
                             ("float32", wide_problem(40, 512), "streamed"),
                             ("bfloat16", wide_problem(36, 1024), "streamed"),
                             ("float32", wide_problem(36, 1152), "column"),
                             ("bfloat16", wide_problem(24, 2048), "column"),
                             ("float32", wide_problem(24, 1152), "column"),
                             ("bfloat16", wide_problem(24, 1152), "column")):
        blocks, masks, D, alpha = inputs or problem(36, 36, 0, D_np)
        cfg = SparseProxConfig(n_iter=100, matmul_dtype=mm)
        eager = pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha)
        graph = Captured(lambda: pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha), "cuda")
        graph()  # the warm-up, eager
        ISTA_KERNEL.launches = 0
        replayed = graph()  # captured, then replayed
        again = graph()
        torch.cuda.synchronize()
        if graph.b1_launches != 1 or ISTA_KERNEL.launches != 2:
            raise AssertionError(f"the graph holds {graph.b1_launches} launches of B1 and two replays counted "
                                 f"{ISTA_KERNEL.launches}; expected 1 and 2")
        if not (torch.equal(replayed, eager) and torch.equal(again, eager)):
            raise AssertionError(f"{mm}: B1 replayed from a graph differs from the eager launch")
        if graph.b1_plan.tier != tier:
            raise AssertionError(f"B1 at P {graph.b1_plan.P}: tier {graph.b1_plan.tier}")
        ms_graph = time_cuda(graph)
        ms_eager = time_cuda(lambda: pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha))
        log(f"  P {blocks.shape[1]}, K {D.shape[1]} {mm:9s} (tier {graph.b1_plan.tier}) replay equals the eager "
            f"launch bit for bit; replay {ms_graph:.4f} ms, eager call {ms_eager:.4f} ms; launches counted per "
            "replay 1")
    blocks, masks, D, alpha = problem(36, 36, 0, D_np)

    log(f"[scanned] the lrs_pnp preset's step: Solver.run_scanned({SCAN_STEPS}) against run({SCAN_STEPS}), "
        "from the same state")
    solver = Solver(sample, D_np, PRESETS["lrs_pnp"]())
    solver.run(2)  # cuSOLVER and cuBLAS set up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_state, eager_hist = solver.run(SCAN_STEPS)
    torch.cuda.synchronize()
    eager_wall = time.perf_counter() - t0
    (scan_state, scan_hist), first_wall = drive(
        "lrs_pnp run_scanned", lambda: solver.run_scanned(SCAN_STEPS), launches=SCAN_STEPS, nB=144)
    by_path["lrs_pnp_run_scanned"] = ISTA_KERNEL.launches
    t0 = time.perf_counter()
    warm_state, _ = solver.run_scanned(SCAN_STEPS)
    torch.cuda.synchronize()
    scan_wall = time.perf_counter() - t0
    gap, _ = relative_error(scan_state.X, eager_state.X)
    same = torch.equal(scan_state.X, eager_state.X) and torch.equal(warm_state.X, eager_state.X)
    log(f"  X after {SCAN_STEPS} steps: {'equal bits' if same else f'max|dX|/max|X| = {gap:.3e}'}; MPSNR "
        f"{scan_hist['mpsnr'][-1]:.4f} (run {eager_hist['mpsnr'][-1]:.4f}); B1 launches {by_path['lrs_pnp_run_scanned']} "
        f"in {SCAN_STEPS} steps, the first call capturing ({first_wall:.3f} s)")
    if not same or not np.array_equal(np.float32(eager_hist["mpsnr"]), scan_hist["mpsnr"]):
        raise AssertionError("lrs_pnp: run_scanned differs from run")
    eager_step = statistics.median(eager_hist["seconds"])
    log(f"  per step: run {eager_step * 1e3:.3f} ms (median), {eager_wall / SCAN_STEPS * 1e3:.3f} ms sustained; "
        f"run_scanned {scan_wall / SCAN_STEPS * 1e3:.3f} ms sustained; card {smi}")
    prof = {"run": profile_window(lambda: solver.run(SCAN_STEPS), SCAN_STEPS),
            "run_scanned": profile_window(lambda: solver.run_scanned(SCAN_STEPS), SCAN_STEPS)}
    for k, p in prof.items():
        log(f"  per step, {k:11s}: {fmt_profile(p)}")

    log(f"[scanned] dip: the preset, 2 outer steps through run and through run_scanned from the same seed, "
        f"the DIP fit capped at {STOP_CAP}, above its stop")
    preset = PRESETS["dip"]()
    cfg = dataclasses.replace(preset, dip=dataclasses.replace(preset.dip, num_iter=STOP_CAP))
    solver = Solver(sample, D_np, cfg)
    fit_fn, first_fit = solver.stages.dip_fit, {}

    def recording_fit(dip_input, target, mask, generator=None, **kw):
        # the first fit's inputs and generator state, for the chunk lengths below
        if not first_fit:
            first_fit.update(args=(dip_input.clone(), target, mask), state=generator.get_state())
        return fit_fn(dip_input, target, mask, generator=generator, **kw)

    solver.stages.dip_fit = recording_fit
    t0 = time.perf_counter()
    run_state, run_hist = solver.run(2)
    torch.cuda.synchronize()
    run_wall = time.perf_counter() - t0
    solver.stages.dip_fit = fit_fn
    (scan_state, scan_hist), wall = drive("dip run_scanned", lambda: solver.run_scanned(2), launches=2, nB=144)
    by_path["dip_run_scanned"] = ISTA_KERNEL.launches
    check_recovery("dip run_scanned", scan_state.X.cpu().numpy().reshape(36, 36, 128), (36, 36, 128),
                   float(scan_hist["mpsnr"][-1]), input_mpsnr)
    run_iters = [int(v) for v in run_hist["dip_iters"]]
    same = torch.equal(scan_state.X, run_state.X)
    log(f"  dip_iters run {run_iters}, run_scanned {scan_hist['dip_iters'].tolist()} (phase 4, uncapped: "
        f"{[int(v) for v in dip_first[1]['dip_iters']]}); X: run_scanned {'equals' if same else 'differs from'} run "
        f"bit for bit; MPSNR {scan_hist['mpsnr'].round(4).tolist()}; wall run {run_wall:.2f} s, run_scanned "
        f"{wall:.2f} s (the capture of both graphs and of the fit included), B1 launches {ISTA_KERNEL.launches}")
    if not (same and scan_hist["dip_iters"].tolist() == run_iters):
        raise AssertionError("dip, the preset: run_scanned differs from run")
    t0 = time.perf_counter()
    host_cube, host_hist, host_reads = run_fits(Solver(sample, D_np, cfg), 2, host_stepped=True)
    host_wall = time.perf_counter() - t0
    same = (np.array_equal(host_cube, run_state.X.cpu().numpy().reshape(36, 36, 128))
            and [int(v) for v in host_hist["dip_iters"]] == run_iters)
    log(f"  host-stepped fits (a new solver, {host_reads} stop-flag reads): run and run_scanned "
        f"{'equal' if same else 'differ from'} them bit for bit; wall {host_wall:.2f} s")
    if not same:
        raise AssertionError("dip, the preset: run and run_scanned differ from the host-stepped fits")
    if max(run_iters) >= STOP_CAP:
        raise AssertionError(f"dip, the preset: a fit ran to the cap of {STOP_CAP} ({run_iters})")
    stops = [n for n in run_iters if n < STOP_CAP]
    for c in (1, 4, FIT_CHUNK, 16, 32):
        waste = [-(-n // c) * c - n for n in stops]
        log(f"  chunk {c:2d}: iterations replayed after the stop in the {len(waste)} fits that stopped "
            f"before the cap: {waste}")

    log("[scanned] phase 4's inpaint(variant='dip', n_iters=2) once more, from the same seed")
    first_cube, first_hist = dip_first
    (cube, hist), wall = drive("dip again", lambda: port.inpaint(
        sample.noisy, sample.mask, variant="dip", clean=sample.clean, n_iters=2), launches=2, nB=144)
    by_path["dip_again"] = ISTA_KERNEL.launches
    same = np.array_equal(cube, first_cube) and list(hist["dip_iters"]) == list(first_hist["dip_iters"])
    log(f"  dip_iters {[int(v) for v in hist['dip_iters']]} (phase 4 {[int(v) for v in first_hist['dip_iters']]}); "
        f"the cube {'equals' if same else 'differs from'} phase 4's bit for bit; wall {wall:.2f} s")
    if not same:
        raise AssertionError(f"two dip solves from one seed differ: max|d| {np.abs(cube - first_cube).max():.3e}")

    log(f"[scanned] ms per DIP iteration, host-stepped (eager) against replayed from a graph (chunk {FIT_CHUNK}), "
        f"{FIT_TIMED} iterations at 36x36x128, each beside the same net's unordered formulation "
        "(scripts/time_dip_formulations.py)")
    formulations = _load_script("time_dip_formulations")
    c = solver.consts
    Z = torch.from_numpy(sample.noisy).cuda()[None]
    fit_ms = {}
    for label, variant, dtype in formulations.NETS:
        vcfg = PRESETS[variant]()
        net = default_net(vcfg, 128).cuda()
        fit = DipFit(net, dataclasses.replace(vcfg.dip, num_iter=FIT_TIMED, patience=10**9, compute_dtype=dtype))
        gen = torch.Generator(device="cuda")
        row = {}
        for mode, chunk in (("eager", None), ("graph", FIT_CHUNK)):
            first = fit(Z, c.dip_target, c.dip_mask, generator=gen.manual_seed(0), chunk=chunk).out  # set-up / capture
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            row[mode + "_out"] = fit(Z, c.dip_target, c.dip_mask, generator=gen.manual_seed(0), chunk=chunk).out
            torch.cuda.synchronize()
            row[mode] = (time.perf_counter() - t0) * 1e3 / FIT_TIMED
            row[mode + "_repeats"] = torch.equal(first, row[mode + "_out"])
            row[mode + "_prof"] = profile_window(
                lambda: fit(Z, c.dip_target, c.dip_mask, generator=gen.manual_seed(0), chunk=chunk), FIT_TIMED)
            with formulations.unordered_formulation():
                row["unordered_" + mode] = formulations.ms_per_iteration(
                    variant, dtype, FIT_TIMED, chunk, Z, c.dip_target, c.dip_mask)
        graphed_is_eager = torch.equal(row["graph_out"], row["eager_out"])
        fit_ms[label] = {k: row[k] for k in ("eager", "graph", "unordered_eager", "unordered_graph")}
        log(f"  {label:20s} eager {row['eager']:.3f} ms, graph {row['graph']:.3f} ms per iteration "
            f"({row['eager'] / row['graph']:.2f}x); unordered formulation eager {row['unordered_eager']:.3f} ms, "
            f"graph {row['unordered_graph']:.3f} ms; card {smi}; two eager fits {'equal' if row['eager_repeats'] else 'differ'}, "
            f"two graphed fits {'equal' if row['graph_repeats'] else 'differ'}, graphed "
            f"{'equals' if graphed_is_eager else 'differs from'} eager "
            f"({relative_error(row['graph_out'], row['eager_out'])[0]:.3e} of max|out|)")
        for mode in ("eager", "graph"):
            log(f"      {mode}: {fmt_profile(row[mode + '_prof'])} per iteration")
        if not (row["eager_repeats"] and row["graph_repeats"] and graphed_is_eager):
            raise AssertionError(f"{label}: the DIP fit does not repeat bit for bit")
        del net, fit

    log("[scanned] one DIP iteration of each solve-capable net (and a fit step of every other get_net key) "
        "under torch.use_deterministic_algorithms, in a child process (scripts/probe_deterministic.py)")
    t0 = time.perf_counter()
    probe = subprocess.run(
        [sys.executable, str(Path(__file__).resolve().parent / "scripts" / "probe_deterministic.py")],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT,
    )
    log("  " + (probe.stdout.strip().splitlines() or ["(no output)"])[-1] + f" ({time.perf_counter() - t0:.1f} s)")
    if probe.returncode != 0:
        raise AssertionError(f"the determinism probe failed ({probe.returncode}): {probe.stderr[-2000:]}")

    log("[scanned] chunk length of the DIP fit: the first fit of the preset's run above again, from its inputs "
        f"and generator state (capped at {STOP_CAP}): every length stops where run's fit stopped")
    fit = DipFit(default_net(cfg, 128).cuda(), cfg.dip)
    gen = torch.Generator(device="cuda")
    fit(*first_fit["args"], generator=gen.set_state(first_fit["state"]), chunk=FIT_CHUNK)  # capture
    ran = set()
    for chunk in (1, FIT_CHUNK, 32):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit(*first_fit["args"], generator=gen.set_state(first_fit["state"]), chunk=chunk)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ran.add((res.n_iters, bool(res.stopped)))
        log(f"  chunk {chunk:2d}: {res.n_iters} iterations ({'stopped' if res.stopped else 'the cap'}), "
            f"{ms:.1f} ms, {ms / res.n_iters:.3f} ms per iteration, "
            f"{-(-res.n_iters // chunk) * chunk - res.n_iters} replayed after the stop")
    if ran != {(run_iters[0], True)}:
        raise AssertionError(f"the chunk lengths ran {sorted(ran)} iterations (stopped?); the first fit of run "
                             f"stopped after {run_iters[0]}")

    log(f"[scanned] inpaint(variant='dip_tuned', seeds=[0, 1], n_iters=2) through run_chunked, DIP fits capped "
        f"at {DIP_CAP}")
    tuned = PRESETS["dip_tuned"]()
    (cube, hist), wall = drive("dip_tuned ensemble, run_chunked", lambda: port.inpaint(
        sample.noisy, sample.mask, variant="dip_tuned", clean=sample.clean, n_iters=2, seeds=[0, 1],
        dip=dataclasses.replace(tuned.dip, num_iter=DIP_CAP)), launches=2, nB=288)
    by_path["dip_tuned_seeds_run_chunked"] = ISTA_KERNEL.launches
    log(f"  dip_iters {hist['dip_iters'].tolist()}, mpsnr {hist['mpsnr'].round(4).tolist()}, ens_mpsnr "
        f"{hist['ens_mpsnr'].round(4).tolist()}; wall {wall:.2f} s")
    for k, shape, dtype in (("mpsnr", (2, 2), np.float32), ("ssim", (2, 2), np.float32),
                            ("dip_iters", (2, 2), np.int32), ("ens_mpsnr", (2,), np.float32),
                            ("ens_ssim", (2,), np.float32)):
        if hist[k].shape != shape or hist[k].dtype != dtype or not np.isfinite(hist[k]).all():
            raise AssertionError(f"ensemble history {k}: {hist[k].shape} {hist[k].dtype}, expected {shape} {dtype}")
    check_recovery("dip_tuned run_chunked", cube, (36, 36, 128), float(hist["ens_mpsnr"][-1]), input_mpsnr)

    log("[scanned] inpaint_scene(variant='lrs_pnp', tile_batch=4) on the 72x72x128 scene, scan=True against "
        "scan=False")
    (rec_scan, wall_scan) = drive("inpaint_scene scan", lambda: port.inpaint_scene(
        scene.noisy, scene.mask, variant="lrs_pnp", tile_batch=4, scan=True), launches=2, nB=576)
    by_path["inpaint_scene_scan"] = ISTA_KERNEL.launches
    t0 = time.perf_counter()
    rec_host = port.inpaint_scene(scene.noisy, scene.mask, variant="lrs_pnp", tile_batch=4, scan=False)
    wall_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    port.inpaint_scene(scene.noisy, scene.mask, variant="lrs_pnp", tile_batch=4, scan=True)
    wall_warm = time.perf_counter() - t0
    log(f"  scan=True {'equals' if np.array_equal(rec_scan, rec_host) else 'differs from'} scan=False bit for "
        f"bit; wall: scan=True {wall_scan:.3f} s (capturing), {wall_warm:.3f} s warm, scan=False {wall_host:.3f} s")
    if not np.array_equal(rec_scan, rec_host):
        raise AssertionError("inpaint_scene: scan=True differs from scan=False")

    log("[scanned] B1's yardstick (its 200 torch.matmul calls) at the engines' and the ranks' shapes, and "
        "its plain loop at the engines' (nB 72's is in phase 8)")
    library, plain = {}, {}
    P, K = D.shape
    scene_rows, big = problem(72, 72, 2, D_np), problem(144, 144, 1, D_np)
    for nB in (72, 288, 576, 2304):
        rows = big if nB == 2304 else tuple(t[:nB] for t in scene_rows[:2]) + (D, scene_rows[3][:nB])
        for mm, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x = torch.zeros((nB, K), device="cuda", dtype=dt)
            r = torch.zeros((nB, P), device="cuda", dtype=dt)
            Dm = D.to(dt)

            def matmuls():
                for _ in range(100):
                    torch.matmul(x, Dm.T)
                    torch.matmul(r, Dm)

            library[f"nB{nB}_{mm}"] = time_cuda(matmuls)
            if nB != 72:
                cfg = SparseProxConfig(n_iter=100, matmul_dtype=mm)
                plain[f"nB{nB}_{mm}"] = time_cuda(
                    lambda: pnp_ista_blocks(rows[0], rows[1], D, cfg, alpha=rows[3]), warmup=1, reps=3)
        log(f"  nB {nB:4d}: library_ms f32 {library[f'nB{nB}_float32']:.4f}, bf16 {library[f'nB{nB}_bfloat16']:.4f}"
            + (f"; plain_ms f32 {plain[f'nB{nB}_float32']:.4f}, bf16 {plain[f'nB{nB}_bfloat16']:.4f}"
               if nB != 72 else "") + f"; card {smi}")
    log(f"  (scanned phase {time.perf_counter() - t_phase:.1f} s)")
    return {"library_ms": library, "plain_ms": plain, "lrs_pnp_step": prof, "dip_iteration_ms": fit_ms}


def main() -> int:
    t_start = time.perf_counter()
    try:
        import numpy as np
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        import lrs_pnp_dip_tpu_torch as port
        from lrs_pnp_dip_tpu_torch.data import (
            load_trained_dictionary, matlab_twin_sample, synthetic_sample,
        )
        from lrs_pnp_dip_tpu_torch.models import NET_TYPES, Skip, get_net
        from lrs_pnp_dip_tpu_torch.ops import (
            ISTA_KERNEL, bm3d_prox, compute_alpha, mpsnr, pnp_ista_blocks, pnp_ista_blocks_fused,
            sparse_prox, ssim_matlab, svt_gram,
        )
        from lrs_pnp_dip_tpu_torch.solvers import FIT_CHUNK, SeedEnsembleSolver, Solver
        from lrs_pnp_dip_tpu_torch.solvers.tiled import _tiled_engine
        from lrs_pnp_dip_tpu_torch.utils import resolve_device
        from lrs_pnp_dip_tpu_torch.utils.config import (
            PRESETS, DipConfig, SolverConfig, SparseProxConfig,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1

    resolve_device("cuda")  # TF32 off for matmuls and cuDNN convolutions
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, card {name} ({smi})")
    peaks = peaks_for(name)

    # 1. build
    t0 = time.perf_counter()
    ISTA_KERNEL.build()
    log(f"[build] kernel B1 built in {time.perf_counter() - t0:.2f} s")
    for line in ISTA_KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    # 2. kernel against its plain version
    D_np = load_trained_dictionary(512)
    log("[check] kernel B1 vs plain pnp_ista_blocks, 100 iterations, trace4 alpha")
    main = problem(36, 36, 0, D_np)
    main_err = check_kernel(*main, "float32")
    check_kernel(*main, "bfloat16")
    ragged = tuple(t[:13] for t in main[:2]) + (main[2], main[3][:13])
    for mm in ("float32", "bfloat16"):
        check_kernel(*ragged, mm)
    big = problem(144, 144, 1, D_np)
    if big[0].shape[0] != 2304:
        raise AssertionError(f"expected 2304 blocks, got {big[0].shape[0]}")
    for mm in ("float32", "bfloat16"):
        check_kernel(*big, mm)
    log("[check] the same at the lrs_pnp sparse settings: 80 iterations, specnorm alpha, h_scale 0.1")
    lrs_pnp = dict(n_iter=80, alpha_mode="specnorm", h_scale=0.1)
    specnorm_alpha = compute_alpha(main[2], main[1], SparseProxConfig(**lrs_pnp))
    for mm in ("float32", "bfloat16"):
        check_kernel(*main[:3], specnorm_alpha, mm, bf16_match=BF16_MATCH_SHARP, **lrs_pnp)
    log("[check] two launches on the same inputs")
    for mm in ("float32", "bfloat16"):
        check_same_bits(*main, mm)
        check_same_bits(*big, mm)
    log("[check] B1 past the resident kernel at nB 144: random unit-column dictionaries, blocks of a 72x72x128 "
        "synthetic cube, 100 iterations, trace4 alpha")
    wide_timing = {}
    t_phase = time.perf_counter()
    for block, K, types in WIDE_SHAPES:
        wide = wide_problem(block, K)
        bf16_match, sens, tc = bf16_limit(*wide, f"block {block} (P {block * block}), K {K}")
        for mm in types:
            err = check_kernel(*wide, mm, bf16_match=bf16_match)
            check_same_bits(*wide, mm)
            t = time_b1(*wide, mm, peaks)
            plan = ISTA_KERNEL.plan(144, block * block, K, mm == "bfloat16")
            wide_timing[f"P{block * block}_K{K}_{mm}"] = dict(
                t, max_abs_err=err, tier=plan.tier, waves=plan.waves,
                l2_bytes_per_iteration=plan.l2_bytes_per_iteration, order_sensitivity=sens,
                tensor_core_sensitivity=tc, bf16_limit=bf16_match)
            log(f"  {mm:9s} kernel_ms={t['ms']:.4f} bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) -> "
                f"{t['bound_ms'] / t['ms']:.1%} of bound; plain_ms={t['plain_ms']:.4f}; {2 * 100} {mm} "
                f"torch.matmul calls {t['library_ms']:.4f} ms; card {smi}")
    wide_timing.update(wide_tiles_of_16(peaks, smi))
    log(f"  (streamed shapes {time.perf_counter() - t_phase:.1f} s)")
    log("[check] the column kernel at nB 144 past the streamed kernel's columns: random unit-column "
        "dictionaries, blocks of a 72x72x128 synthetic cube, 100 iterations, trace4 alpha")
    t_phase = time.perf_counter()
    long_k_timing = long_k_shapes(peaks, smi)
    long_k_timing["P256_K3000_float32_nB13_20it"] = long_k_check(peaks)
    log(f"  (long-K shapes {time.perf_counter() - t_phase:.1f} s)")
    log("[check] B1's tiers at the shapes where its plan chooses (TIER_SHAPES): every tiling of plan_candidates "
        "against the plain loop, equal bits on repeat, all timed in turns; random blocks, 100 iterations, trace4 alpha")
    t_phase = time.perf_counter()
    tier_timing = tier_sweep(peaks, smi)
    log(f"  (tier sweep {time.perf_counter() - t_phase:.1f} s)")

    # 3. timing at the main-path shape
    blocks, masks, D, alpha = main
    nB, P = blocks.shape
    K, n_iter = D.shape[1], 100
    timing = {}
    for mm in ("float32", "bfloat16"):
        cfg = SparseProxConfig(n_iter=n_iter, matmul_dtype=mm)
        k_ms = time_cuda(lambda: pnp_ista_blocks_fused(blocks, masks, D, cfg, alpha=alpha))
        p_ms = time_cuda(lambda: pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha), reps=5)
        b_ms, by, flops, io_bytes = bound_ms(nB, P, K, n_iter, mm, peaks)
        timing[mm] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by)
    library = {}
    for mm, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x = torch.zeros((nB, K), device="cuda", dtype=dt)
        r = torch.zeros((nB, P), device="cuda", dtype=dt)
        Dm = D.to(dt)

        def matmuls():
            for _ in range(n_iter):
                torch.matmul(x, Dm.T)
                torch.matmul(r, Dm)

        library[mm] = time_cuda(matmuls)
    library_ms = library["float32"]
    log(f"[timing] B1 at nB={nB}, P={P}, K={K}, n_iter={n_iter}: {flops:.3e} flops, "
        f"{io_bytes} bytes in+out; card {smi}")
    for mm, t in timing.items():
        log(f"  {mm:9s} kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) -> {t['bound_ms'] / t['ms']:.1%} of bound")
    log(f"  library_ms={library_ms:.4f} f32, {library['bfloat16']:.4f} bf16: the {2 * n_iter} torch.matmul "
        "calls of the two products alone — a partial yardstick, since no single PyTorch call computes "
        "the fused loop with its NLM")

    nB_big = big[0].shape[0]
    log(f"[timing] B1 at nB={nB_big} (the 144x144 cube), 16 times the main shape's work")
    for mm in ("float32", "bfloat16"):
        cfg = SparseProxConfig(n_iter=n_iter, matmul_dtype=mm)
        k_ms = time_cuda(lambda: pnp_ista_blocks_fused(*big[:3], cfg, alpha=big[3]), warmup=1, reps=3)
        b_ms, by, _, _ = bound_ms(nB_big, P, K, n_iter, mm, peaks)
        log(f"  {mm:9s} kernel_ms={k_ms:.4f} bound_ms={b_ms:.4f} ({by}) -> {b_ms / k_ms:.1%} of bound")
    del big

    # 4. the dip solve through the user entry point
    log("[solve] api.inpaint(variant='dip', n_iters=2) on synthetic_sample(36, 36, 128, seed=0)")
    sample = synthetic_sample(36, 36, 128, seed=0)
    input_mpsnr = float(mpsnr(torch.from_numpy(sample.clean), torch.from_numpy(sample.noisy)))
    torch.cuda.reset_peak_memory_stats()
    ISTA_KERNEL.launches = 0
    t0 = time.perf_counter()
    cube, hist = port.inpaint(sample.noisy, sample.mask, variant="dip", clean=sample.clean, n_iters=2)
    solve_s = time.perf_counter() - t0
    dip_first = (cube, hist)  # repeated in phase 9
    launches = ISTA_KERNEL.launches
    by_path = {"dip": launches}
    f32_dip_ms = (hist["seconds"][1] * 1e3 - timing["float32"]["ms"]) / max(hist["dip_iters"][1], 1)
    for i in range(2):
        dip_ms = (hist["seconds"][i] * 1e3 - timing["float32"]["ms"]) / max(hist["dip_iters"][i], 1)
        log(f"  step {i}: mpsnr={hist['mpsnr'][i]:.4f} ssim={hist['ssim'][i]:.4f} "
            f"dip_iters={int(hist['dip_iters'][i])} wall_s={hist['seconds'][i]:.3f} "
            f"(~{dip_ms:.3f} ms per DIP iteration besides B1)")
    log(f"  input mpsnr={input_mpsnr:.4f}; solve {solve_s:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; B1 launches {launches} "
        f"({launches / 2:g} per outer step)")
    if cube.shape != (36, 36, 128) or not bool(torch.isfinite(torch.from_numpy(cube)).all()):
        raise AssertionError("the recovered cube is not a finite (36, 36, 128) array")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), hist["mpsnr"] + hist["ssim"])):
        raise AssertionError("non-finite metrics")
    if launches != 2:
        raise AssertionError(f"B1 launched {launches} times in 2 outer steps, expected 2")
    if not hist["mpsnr"][-1] > input_mpsnr:
        raise AssertionError(f"final MPSNR {hist['mpsnr'][-1]:.4f} not above input {input_mpsnr:.4f}")
    replay_turns(sample, D_np, PRESETS["dip"](), cube, hist, smi)

    # the same short outer step on the card and on the CPU, same DIP init
    small = synthetic_sample(12, 12, 16, missing=0.1, seed=3)
    rng_D = torch.Generator().manual_seed(0)
    D_small = torch.randn((36, 48), generator=rng_D)
    D_small = (D_small / D_small.norm(dim=0, keepdim=True)).numpy()
    cfg_small = SolverConfig(
        block_size=6, stride=6, sparse=SparseProxConfig(n_iter=20),
        dip=DipConfig(num_iter=20, buffer_size=3, patience=2, learning_rate=0.01),
    )
    net_kw = dict(num_input_channels=16, num_output_channels=16, channels_down=(8, 8),
                  channels_up=(8, 8), channels_skip=(4, 4), pad="reflection")
    init_net = Skip(**net_kw)
    init_net.reset_parameters(torch.Generator().manual_seed(1))
    init = {k: v.clone() for k, v in init_net.state_dict().items()}
    outs = {}
    for dev in ("cuda", "cpu"):
        solver = Solver(small, D_small, cfg_small, net=Skip(**net_kw), device=dev,
                        dip_init=lambda itr: init)
        state, aux = solver.step(solver.init_state())
        outs[dev] = (state.X.cpu(), aux.dip_iters)
    scale = float(outs["cpu"][0].abs().max())
    err = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    log(f"  small outer step, card vs CPU: max|dX|={err:.3e} (scale {scale:.3e}), "
        f"dip_iters {outs['cuda'][1]} vs {outs['cpu'][1]}")
    if outs["cuda"][1] != outs["cpu"][1] or not err < 1e-3 * scale:
        raise AssertionError("the card's outer step disagrees with the CPU's")

    # 5. every other path, each through its user entry point at full width
    def step_report(label, hist, wall):
        iters = np.asarray(hist["dip_iters"]).reshape(len(hist["dip_iters"]), -1)
        log(f"  {label}: wall {wall:.2f} s, DIP iterations per step {iters.sum(axis=1).astype(int).tolist()}, "
            f"B1 launches {ISTA_KERNEL.launches} (nB {ISTA_KERNEL.last_plan.nB}, "
            f"{'bf16' if ISTA_KERNEL.last_plan.bf16 else 'f32'} operands)")

    def capped(variant):
        base = PRESETS[variant]()
        return dict(dip=dataclasses.replace(base.dip, num_iter=DIP_CAP))

    log("[paths] inpaint(variant='lrs_pnp'): the whole 2-iteration preset, card and CPU")
    (cube, hist), wall = drive("lrs_pnp", lambda: port.inpaint(
        sample.noisy, sample.mask, variant="lrs_pnp", clean=sample.clean), launches=2, nB=144)
    by_path["lrs_pnp"] = ISTA_KERNEL.launches
    step_report("lrs_pnp", hist, wall)
    check_recovery("lrs_pnp", cube, (36, 36, 128), hist["mpsnr"][-1], input_mpsnr)
    t0 = time.perf_counter()
    cpu_cube, cpu_hist = port.inpaint(sample.noisy, sample.mask, variant="lrs_pnp", clean=sample.clean, device="cpu")
    err = float(np.abs(cube - cpu_cube).max()) / float(np.abs(cpu_cube).max())
    log(f"  mpsnr {[round(v, 4) for v in hist['mpsnr']]} (CPU {[round(v, 4) for v in cpu_hist['mpsnr']]}, "
        f"{time.perf_counter() - t0:.2f} s), per step {[round(v * 1e3, 2) for v in hist['seconds']]} ms; "
        f"card vs CPU max|dX|/max|X| = {err:.3e} (limit {SOLVE_MATCH})")
    if not err < SOLVE_MATCH:
        raise AssertionError("the card's lrs_pnp solve disagrees with the CPU's")

    dip_ms = {"dip (skip-128 f32)": f32_dip_ms}
    for variant, net, bf16 in (("dip_1lip", "Lipschitz U-Net f32", False), ("dip_fast", "skip-128 bf16", True)):
        log(f"[paths] inpaint(variant={variant!r}, n_iters=2), DIP fit capped at {DIP_CAP}")
        (cube, hist), wall = drive(variant, lambda: port.inpaint(
            sample.noisy, sample.mask, variant=variant, clean=sample.clean, n_iters=2, **capped(variant)),
            launches=2, nB=144, bf16=bf16)
        by_path[variant] = ISTA_KERNEL.launches
        step_report(variant, hist, wall)
        check_recovery(variant, cube, (36, 36, 128), hist["mpsnr"][-1], input_mpsnr)
        b1 = timing["bfloat16" if bf16 else "float32"]["ms"]
        dip_ms[f"{variant} ({net})"] = (hist["seconds"][1] * 1e3 - b1) / max(hist["dip_iters"][1], 1)
        log(f"  mpsnr {[round(v, 4) for v in hist['mpsnr']]}, per step {[round(v, 3) for v in hist['seconds']]} s")
        host_cube, host_hist, reads = run_fits(Solver(sample, D_np, PRESETS[variant](**capped(variant))), 2, True)
        same = np.array_equal(cube, host_cube) and hist["dip_iters"] == host_hist["dip_iters"]
        log(f"  the same 2 steps with host-stepped fits ({reads} stop-flag reads): the cube "
            f"{'equals' if same else 'differs from'} the replayed fits' bit for bit, dip_iters "
            f"{[int(v) for v in host_hist['dip_iters']]}; per step {[round(v, 3) for v in host_hist['seconds']]} s")
        if not same:
            raise AssertionError(f"{variant}: the replayed fits differ from the host-stepped ones")
    log("  ms per DIP iteration in each path's second outer step (wall less B1, over the iterations): "
        + ", ".join(f"{k} {v:.3f}" for k, v in dip_ms.items()))

    log(f"[paths] inpaint(variant='dip_fast', dictionary=<1296x1024 unit columns, seed {WIDE_DICT_SEED}>, "
        f"n_iters=2), DIP fit capped at {DIP_CAP}: B1's streamed kernel with bf16 operands")
    rng = np.random.default_rng(WIDE_DICT_SEED)
    wide_D = rng.standard_normal((1296, 1024)).astype(np.float32)
    wide_D /= np.linalg.norm(wide_D, axis=0, keepdims=True)
    (cube, hist), wall = drive("dip_fast K1024", lambda: port.inpaint(
        sample.noisy, sample.mask, variant="dip_fast", clean=sample.clean, n_iters=2, dictionary=wide_D,
        **capped("dip_fast")), launches=2, nB=144, bf16=True)
    by_path["dip_fast_K1024"] = ISTA_KERNEL.launches
    plan = ISTA_KERNEL.last_plan
    if (plan.tier, plan.K) != ("streamed", 1024):
        raise AssertionError(f"dip_fast with K 1024 took B1's {plan.tier} tier at K {plan.K}")
    step_report("dip_fast, K 1024", hist, wall)
    check_recovery("dip_fast K1024", cube, (36, 36, 128), hist["mpsnr"][-1], input_mpsnr)
    log(f"  mpsnr {[round(v, 4) for v in hist['mpsnr']]} (input {input_mpsnr:.4f}); plan: {describe_plan(plan)}")

    log(f"[paths] inpaint(variant='lrs_pnp', dictionary=<1296x1152 unit columns, seed {LONG_DICT_SEED}>): the "
        "whole preset on B1's column kernel (f32 past 1024 columns)")
    rng = np.random.default_rng(LONG_DICT_SEED)
    long_D = rng.standard_normal((1296, 1152)).astype(np.float32)
    long_D /= np.linalg.norm(long_D, axis=0, keepdims=True)
    (cube, hist), wall = drive("lrs_pnp K1152", lambda: port.inpaint(
        sample.noisy, sample.mask, variant="lrs_pnp", clean=sample.clean, dictionary=long_D, device="cuda"),
        launches=2, nB=144)
    by_path["lrs_pnp_K1152"] = ISTA_KERNEL.launches
    plan = ISTA_KERNEL.last_plan
    if (plan.tier, plan.K) != ("column", 1152):
        raise AssertionError(f"lrs_pnp with K 1152 took B1's {plan.tier} tier at K {plan.K}")
    step_report("lrs_pnp, K 1152", hist, wall)
    check_recovery("lrs_pnp K1152", cube, (36, 36, 128), hist["mpsnr"][-1], input_mpsnr)
    log(f"  mpsnr {[round(v, 4) for v in hist['mpsnr']]} (input {input_mpsnr:.4f}), per step "
        f"{[round(v * 1e3, 2) for v in hist['seconds']]} ms; plan: {describe_plan(plan)}")

    log(f"[paths] inpaint(variant='dip_tuned', seeds=[0, 1], n_iters=2), DIP fit capped at {DIP_CAP}")
    (cube, hist), wall = drive("dip_tuned ensemble", lambda: port.inpaint(
        sample.noisy, sample.mask, variant="dip_tuned", clean=sample.clean, n_iters=2, seeds=[0, 1],
        **capped("dip_tuned")), launches=2, nB=288)
    by_path["dip_tuned_seeds"] = ISTA_KERNEL.launches
    step_report("dip_tuned, 2 seeds", hist, wall)
    if hist["mpsnr"].shape != (2, 2) or hist["ens_mpsnr"].shape != (2,) or not np.isfinite(hist["ens_mpsnr"]).all():
        raise AssertionError(f"ensemble history: mpsnr {hist['mpsnr'].shape}, ens_mpsnr {hist['ens_mpsnr']}")
    check_recovery("dip_tuned ensemble", cube, (36, 36, 128), float(hist["ens_mpsnr"][-1]), input_mpsnr)
    log(f"  per-seed mpsnr {hist['mpsnr'].round(4).tolist()}, ens_mpsnr {hist['ens_mpsnr'].round(4).tolist()}")
    lanes_run = {}
    for mode in ("replayed", "host"):
        ens = SeedEnsembleSolver(sample, D_np, PRESETS["dip_tuned"](**capped("dip_tuned")), [0, 1])
        if mode == "host":
            ens.stages.fit_chunk = None
        t0 = time.perf_counter()
        st, h = ens.run(2)
        lanes_run[mode] = (st.X.mean(dim=0).reshape(36, 36, 128).cpu().numpy(), h, time.perf_counter() - t0)
    (rep_cube, rep_hist, rep_wall), (host_cube, host_hist, host_wall) = lanes_run["replayed"], lanes_run["host"]
    same = np.array_equal(rep_cube, host_cube) and np.array_equal(rep_hist["dip_iters"], host_hist["dip_iters"])
    chunked_same = np.array_equal(cube, rep_cube) and np.array_equal(hist["dip_iters"], rep_hist["dip_iters"])
    log(f"  SeedEnsembleSolver.run, the lanes' fits replayed ({rep_wall:.2f} s) against host-stepped "
        f"({host_wall:.2f} s): the mean cube {'equals' if same else 'differs from'} it bit for bit, dip_iters "
        f"{rep_hist['dip_iters'].tolist()}; inpaint's run_chunked {'equals' if chunked_same else 'differs from'} "
        "run bit for bit")
    if not same:
        raise AssertionError("dip_tuned lanes: the replayed fits differ from the host-stepped ones")

    log("[paths] inpaint_scene(variant='lrs_pnp', tile_batch=4) on synthetic_sample(72, 72, 128, seed=2), card and CPU")
    scene = synthetic_sample(72, 72, 128, seed=2)
    scene_in = float(mpsnr(torch.from_numpy(scene.clean), torch.from_numpy(scene.noisy)))
    rec, wall = drive("inpaint_scene", lambda: port.inpaint_scene(
        scene.noisy, scene.mask, variant="lrs_pnp", tile_batch=4), launches=2, nB=576)
    by_path["inpaint_scene"] = ISTA_KERNEL.launches
    scene_out = float(mpsnr(torch.from_numpy(scene.clean), torch.from_numpy(rec)))
    check_recovery("inpaint_scene", rec, (72, 72, 128), scene_out, scene_in)
    cpu_rec = port.inpaint_scene(scene.noisy, scene.mask, variant="lrs_pnp", tile_batch=4, device="cpu")
    err = float(np.abs(rec - cpu_rec).max()) / float(np.abs(cpu_rec).max())
    log(f"  scene: wall {wall:.2f} s, mpsnr {scene_in:.4f} -> {scene_out:.4f}, B1 launches "
        f"{ISTA_KERNEL.launches} (nB {ISTA_KERNEL.last_plan.nB}); card vs CPU max|dX|/max|X| = {err:.3e} "
        f"(limit {SOLVE_MATCH})")
    if not err < SOLVE_MATCH:
        raise AssertionError("the card's scene disagrees with the CPU's")

    log(f"[paths] inpaint_scene(variant='dip', tile_batch=4, n_iters=2) on the 72x72x128 scene, DIP fit capped at "
        f"{DIP_CAP}: solve_tiled(scan=False), the host-stepped outer loop, with replayed fits, against host-stepped "
        "fits")

    def dip_scene():
        return port.inpaint_scene(scene.noisy, scene.mask, variant="dip", tile_batch=4, n_iters=2, **capped("dip"))

    rec, wall = drive("inpaint_scene dip", dip_scene, launches=2, nB=576)
    by_path["inpaint_scene_dip"] = ISTA_KERNEL.launches
    check_recovery("inpaint_scene dip", rec, (72, 72, 128), float(mpsnr(torch.from_numpy(scene.clean),
                                                                        torch.from_numpy(rec))), scene_in)
    engine = _tiled_engine(PRESETS["dip"](**capped("dip")), (36, 36, 128), None, resolve_device("cuda"))
    engine.stages.fit_chunk = None
    t0 = time.perf_counter()
    try:
        rec_host = dip_scene()
    finally:
        engine.stages.fit_chunk = FIT_CHUNK
    wall_host = time.perf_counter() - t0
    same = np.array_equal(rec, rec_host)
    log(f"  replayed fits {wall:.2f} s, host-stepped {wall_host:.2f} s for the scene; "
        f"{'equal' if same else 'different'} bits; mpsnr {scene_in:.4f} -> "
        f"{float(mpsnr(torch.from_numpy(scene.clean), torch.from_numpy(rec))):.4f}")
    if not same:
        raise AssertionError("inpaint_scene(variant='dip'): the replayed fits differ from the host-stepped ones")

    log("[paths] one concatenated launch of B1 against per-lane launches, nB 576 = 4 x 144")
    lanes = [main] + [problem(36, 36, seed, D_np) for seed in (1, 2, 3)]
    cat = tuple(torch.cat([lane[i] for lane in lanes]) for i in (0, 1)) + (D, torch.cat([lane[3] for lane in lanes]))
    for mm in ("float32", "bfloat16"):
        cfg = SparseProxConfig(n_iter=n_iter, matmul_dtype=mm)
        whole = pnp_ista_blocks_fused(*cat[:3], cfg, alpha=cat[3])
        parts = torch.cat([pnp_ista_blocks_fused(*lane[:3], cfg, alpha=lane[3]) for lane in lanes])
        delta, scale = float((whole - parts).abs().max()), float(parts.abs().max())
        log(f"  {mm:9s} max|delta|={delta:.3e} max|ref|={scale:.3e}")
        if mm == "float32":
            torch.testing.assert_close(whole, parts, **F32_TOL)
        elif not delta < BF16_MATCH * scale:
            raise AssertionError(f"bf16: concatenated vs per-lane {delta:.3g} >= {BF16_MATCH} * {scale:.3g}")
        # B1 against the plain loop at the shapes and settings the engines'
        # launches have: nB 288 (the two seeds of dip_tuned: 100 iterations,
        # trace4) and nB 576 (at the dip settings, and at lrs_pnp's, which
        # the four-tile scene launches)
        half = tuple(t[:288] for t in cat[:2]) + (D, cat[3][:288])
        check_kernel(*half, mm)
        check_kernel(*cat, mm)
        sharp_alpha = compute_alpha(D, cat[1], SparseProxConfig(**lrs_pnp))
        check_kernel(*cat[:3], sharp_alpha, mm, bf16_match=BF16_MATCH_SHARP, **lrs_pnp)
        k_ms = time_cuda(lambda: pnp_ista_blocks_fused(*cat[:3], cfg, alpha=cat[3]), reps=5)
        h_ms = time_cuda(lambda: pnp_ista_blocks_fused(*half[:3], cfg, alpha=half[3]), reps=5)
        log(f"  {mm:9s} B1 at nB 288: {h_ms:.4f} ms (bound {bound_ms(288, P, K, n_iter, mm, peaks)[0]:.4f}); "
            f"at nB 576: {k_ms:.4f} ms (bound {bound_ms(576, P, K, n_iter, mm, peaks)[0]:.4f}); card {smi}")
    Z = torch.from_numpy(scene.noisy).cuda().reshape(4, 1296, 128)
    log(f"  SVT (svt_gram, tau 1/0.9) of one (1296, 128) iterate: {time_cuda(lambda: svt_gram(Z[0], 1 / 0.9)):.4f} ms; "
        f"of 4 in one batched eigh: {time_cuda(lambda: svt_gram(Z, 1 / 0.9)):.4f} ms")

    # 6. every other solver option
    t_phase = time.perf_counter()
    log("[options] inpaint(variant='matlab') on matlab_twin_sample(seed=0, bands=128): all 13 outer "
        "steps, nlm_classic in the plain loop, no launch of B1")
    twin = matlab_twin_sample(seed=0, bands=128)
    twin_in = float(mpsnr(torch.from_numpy(twin.clean), torch.from_numpy(twin.noisy)))
    (cube, hist), wall = drive("matlab", lambda: port.inpaint(
        twin.noisy, twin.mask, variant="matlab", clean=twin.clean), launches=0, nB=0)
    by_path["matlab"] = ISTA_KERNEL.launches
    check_recovery("matlab", cube, (36, 36, 128), hist["mpsnr"][-1], twin_in)
    warm = statistics.median(hist["seconds"][1:])
    # the twin's SSIM divides by 3 whatever the channel count: three bands
    bands = [0, 63, 127]
    twin_ssim = float(ssim_matlab(torch.from_numpy(twin.clean[:, :, bands] * 255),
                                  torch.from_numpy(cube[:, :, bands] * 255)))
    log(f"  wall {wall:.2f} s for {len(hist['seconds'])} steps: first {hist['seconds'][0] * 1e3:.2f} ms, "
        f"warm median {warm * 1e3:.2f} ms per outer step; mpsnr {twin_in:.4f} -> {hist['mpsnr'][-1]:.4f} "
        f"(best {hist['best_mpsnr']:.4f}); ssim_matlab of bands {bands} {twin_ssim:.4f}; B1 launches {ISTA_KERNEL.launches}; "
        f"card {smi}")
    twin_card, _ = port.inpaint(twin.noisy, twin.mask, variant="matlab", clean=twin.clean, n_iters=2)
    twin_cpu, _ = port.inpaint(twin.noisy, twin.mask, variant="matlab", clean=twin.clean, n_iters=2, device="cpu")
    err, _ = relative_error(twin_card, twin_cpu)
    log(f"  2 outer steps, card vs CPU: max|dX|/max|X| = {err:.3e} (limit {SOLVE_MATCH})")
    if not err < SOLVE_MATCH:
        raise AssertionError("the card's matlab solve disagrees with the CPU's")
    log(f"  (matlab phase {time.perf_counter() - t_phase:.1f} s)")
    t_phase = time.perf_counter()

    log("[options] sparse_prox(denoiser='bm3d', 5 iterations) at nB 144 and bm3d_prox on a 36x36x8 cube, "
        "card vs CPU, no launch of B1")
    bm3d_cfg = SparseProxConfig(n_iter=5, alpha_mode="trace4", denoiser="bm3d")
    cube8 = torch.from_numpy(sample.noisy[:, :, :8])

    def bm3d_paths():
        return (sparse_prox(blocks, masks, D, bm3d_cfg, alpha=alpha), bm3d_prox(cube8.cuda(), 0.12))

    (prox_card, den_card), wall = drive("bm3d", bm3d_paths, launches=0, nB=0)
    by_path["bm3d"] = ISTA_KERNEL.launches
    prox_cpu = sparse_prox(blocks.cpu(), masks.cpu(), D.cpu(), bm3d_cfg, alpha=alpha.cpu())
    den_cpu = bm3d_prox(cube8, 0.12)
    if not (bool(torch.isfinite(prox_card).all()) and bool(torch.isfinite(den_card).all())):
        raise AssertionError("bm3d: non-finite output")
    worst, rel = relative_error(prox_card, prox_cpu)
    log(f"  sparse_prox: card vs CPU max|d|/max|ref| = {worst:.3e}, relative L2 {rel:.3e} "
        f"(limits {BM3D_PROX_MATCH})")
    if not (worst < BM3D_PROX_MATCH[0] and rel < BM3D_PROX_MATCH[1]):
        raise AssertionError("the card's bm3d sparse_prox disagrees with the CPU's")
    worst, rel = relative_error(den_card, den_cpu)
    clean8 = torch.from_numpy(sample.clean[:, :, :8])
    db = [float(mpsnr(clean8, t.cpu())) for t in (cube8, den_card, den_cpu)]
    log(f"  bm3d_prox: card vs CPU max|d|/max|ref| = {worst:.3e}, relative L2 {rel:.3e}; mpsnr vs clean "
        f"{db[0]:.4f} -> card {db[1]:.4f}, CPU {db[2]:.4f} (limits: relative L2 {BM3D_CUBE_MATCH[0]}, "
        f"{BM3D_CUBE_MATCH[1]} dB)")
    if not (rel < BM3D_CUBE_MATCH[0] and abs(db[1] - db[2]) < BM3D_CUBE_MATCH[1] and db[1] > db[0]):
        raise AssertionError("the card's bm3d_prox disagrees with the CPU's")
    prox_again, den_again = bm3d_paths()
    torch.cuda.synchronize()
    if not (torch.equal(prox_again, prox_card) and torch.equal(den_again, den_card)):
        raise AssertionError("bm3d: two calls on the card differ: "
                             f"{int((prox_again != prox_card).sum())} and {int((den_again != den_card).sum())} values")
    log("  a second call of each on the card gives equal bits (aggregation in a fixed order)")
    ms = time_cuda(lambda: sparse_prox(blocks, masks, D, bm3d_cfg, alpha=alpha), warmup=1, reps=3)
    log(f"  sparse_prox with bm3d, 5 iterations at nB 144: {ms:.2f} ms (wall of both paths {wall:.2f} s); "
        f"card {smi}")
    log(f"  (bm3d phase {time.perf_counter() - t_phase:.1f} s)")
    t_phase = time.perf_counter()

    log(f"[options] the zoo: every get_net key on the card vs the same weights on the CPU, then one "
        f"`dip` outer step per key at 36x36x128 (DIP fit capped at {ZOO_DIP_CAP})")
    zoo_inputs = {"deep_decoder": (1, 4, 4, 128), "res_decoder": (1, 4, 4, 128), "UNet3D": (1, 128, 32, 32, 1)}
    for key in NET_TYPES:
        shape = zoo_inputs.get(key, (1, 36, 36, 128))
        net = get_net(shape[-1], key, pad="reflection", n_channels=shape[-1])
        net.reset_parameters(torch.Generator().manual_seed(0))
        # a copy for the card: a forward advances lipschitz_unet's power iteration
        card_net = copy.deepcopy(net).cuda()
        x = torch.rand(shape, generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            ref = net(x)
            out = card_net(x.cuda())
            torch.cuda.synchronize()
            worst, _ = relative_error(out, ref)
        log(f"  {key:14s} forward {tuple(shape)} -> {tuple(out.shape)}: card vs CPU {worst:.3e} of max|out| "
            f"(limit {ZOO_MATCH})")
        if not (bool(torch.isfinite(out).all()) and worst < ZOO_MATCH):
            raise AssertionError(f"get_net({key!r}): the card's forward disagrees with the CPU's")
        del net, card_net, out
    log(f"  (zoo forwards {time.perf_counter() - t_phase:.1f} s)")
    t_phase = time.perf_counter()
    dip_cap = dataclasses.replace(PRESETS["dip"]().dip, num_iter=ZOO_DIP_CAP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for key in NET_TYPES:
        def one_step():
            return port.inpaint(sample.noisy, sample.mask, variant="dip", clean=sample.clean, n_iters=1,
                                dip_net=key, dip=dip_cap)
        if key in ZOO_NO_SOLVE:
            ISTA_KERNEL.launches = 0
            try:
                one_step()
            except ZOO_NO_SOLVE[key] as e:
                log(f"  {key:14s} dip step fails as in the JAX package: {type(e).__name__}: {str(e)[:90]}")
            else:
                raise AssertionError(f"dip_net={key!r} ran a solve; the JAX package cannot")
            continue
        (cube, hist), wall = drive(f"dip_net={key}", one_step, launches=1, nB=144)
        by_path[f"dip_net={key}"] = ISTA_KERNEL.launches
        check_recovery(f"dip_net={key}", cube, (36, 36, 128), hist["mpsnr"][-1], input_mpsnr)
        iters = int(hist["dip_iters"][0])
        per_iter = (hist["seconds"][0] * 1e3 - timing["float32"]["ms"]) / max(iters, 1)
        log(f"  {key:14s} dip step: wall {wall:.2f} s, {iters} DIP iterations, ~{per_iter:.3f} ms per "
            f"iteration (first use of the net's shapes and its capture included), mpsnr {hist['mpsnr'][0]:.4f}, "
            f"B1 launches {ISTA_KERNEL.launches} (nB {ISTA_KERNEL.last_plan.nB}); device memory held after it "
            f"{(torch.cuda.memory_allocated() - held) / 2**20:+.1f} MiB")

    log(f"  (zoo dip steps {time.perf_counter() - t_phase:.1f} s; peak device memory over them "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, held after them "
        f"{(torch.cuda.memory_allocated() - held) / 2**20:+.1f} MiB, reserved {torch.cuda.memory_reserved() / 2**20:.1f} "
        "MiB: each solver's captured fit freed with it)")

    # 7. the long tail
    auto_timing = long_tail(port, sample, input_mpsnr, scene, scene_in, capped, by_path, smi, peaks)

    # 8. the sharded engine, ranks sharing the card
    shard_timing = parallel_phase(sample, input_mpsnr, D_np, by_path, peaks)

    # 9. the device-resident solve
    scanned = scanned_phase(port, sample, input_mpsnr, D_np, scene, by_path, smi, peaks, dip_first)

    # 10. report
    log(f"[report] chip_smoke.py total {time.perf_counter() - t_start:.1f} s")
    t = timing["float32"]
    kernels = [{
        "name": "pnp_ista_fused",
        "route": "cuda",
        "source": "lrs_pnp_dip_tpu_torch/csrc/ista.cu",
        "replaces": "lrs_pnp_dip_tpu/ops/ista_pallas.py:179",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": main_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": library_ms,
        # the main shape with bf16 operands: kernel, plain loop, bound and 200 bf16 torch.matmul calls
        "bfloat16": dict(timing["bfloat16"], library_ms=library["bfloat16"]),
        # B1 at the auto-dictionary's shape (nB 324, P 576, K 512), f32 and bf16
        "at_nB324_P576_K512": auto_timing,
        # B1 at nB 144 at the shapes of the streamed kernel (random dictionaries)
        "at_streamed_shapes": wide_timing,
        # B1 at nB 144 at the shapes of the column kernel (random dictionaries)
        "at_long_k_shapes": long_k_timing,
        # every tier that takes each of TIER_SHAPES, timed in turns, and the plan's pick
        "tier_sweep": tier_timing,
        # B1 at nB 72, one rank's share of the main shape under {patch: 2}
        "at_nB72_per_rank": shard_timing,
        # the yardstick at the engines' and the ranks' shapes (nB 72, 288, 576, 2304)
        "library_ms_at": scanned["library_ms"],
        # the plain loop at the engines' shapes (nB 288, 576, 2304)
        "plain_ms_at": scanned["plain_ms"],
        # the lrs_pnp step, host-stepped against device-resident; ms per DIP iteration
        "lrs_pnp_step": scanned["lrs_pnp_step"],
        "dip_iteration_ms": scanned["dip_iteration_ms"],
    }]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
