"""The port's sparse prox (plain PnP-ISTA, NLM, step sizes) against the JAX
package's XLA path and its Pallas kernel in interpret mode.

Tolerances: rtol 1e-4 / atol 1e-6, as in ``tests/test_ista_pallas.py`` —
the products sum in another order, and the kernel-form NLM multiplies by
-1/(9h^2) where the XLA form divides by 9h^2.  Kernel B1 is held to the
bf16 plain loop at max |delta| < BF16_MATCH max |ref|; the last tests show
that this limit rejects a loop that skips the rounding of any operand.

Kernel B1's tiling (``ops/ista_cuda.py:plan_ista``) is plain Python and is
tested here without a card: its row chunks, slices of D and column segments
cover everything once, its shared memory fits one CTA, and a PyTorch loop
that follows the plan step by step (partial products per slice -- in the
streamed tier stage by stage, product 2 of each stage added into the
slice's partial gradient -- summed in the kernel's ring order, the NLM on
each segment with its halo of 4 and the reflect edge; in the column tier
product 1 per CTA over its columns, the partials summed by slice of rows in
ring order, product 2 per CTA over all rows) equals the plain loop at rtol
1e-5 / atol 1e-6: only the order of the f32 sums differs.  Of the tiers that
take a shape (``plan_candidates``) the plan picks the one with the least
predicted time (``predicted_ms``, constants fitted to the card's sweeps in
``scripts/b1_tier_sweeps.jsonl``); the picks at the sweep's shapes are
pinned here."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.ops import ista as jista
from lrs_pnp_dip_tpu.ops.ista_pallas import pnp_ista_blocks_pallas
from lrs_pnp_dip_tpu.ops.nlm import nlm_column_batch_fast as j_nlm
from lrs_pnp_dip_tpu_torch.data import load_trained_dictionary, synthetic_sample
from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, block_grid, extract_blocks, pnp_ista_blocks_fused
from lrs_pnp_dip_tpu_torch.ops import ista as tista
from lrs_pnp_dip_tpu_torch.ops import ista_cuda
from lrs_pnp_dip_tpu_torch.ops.ista_cuda import (
    H100_RESIDENT_CLUSTERS, TIE_MARGIN, FusedIstaKernel, _column_plan, _streamed_plan, column_groups,
    column_scratch_floats, column_smem_bytes, in_tpu_range, pick_plan, plan_candidates, plan_ista,
    plan_smem_bytes, predicted_ms, share_plan, stream_smem_bytes, tile_rows, tpu_vmem_bytes,
)
from lrs_pnp_dip_tpu_torch.ops.nlm import nlm_column_batch_fast as t_nlm
from lrs_pnp_dip_tpu_torch.solvers import make_consts
from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig, dip_preset

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
BF16_MATCH = 1e-5  # as chip_smoke.py


def _problem(seed, P=48, K=32, nB=5, missing_block=False):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((P, K)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    Y = rng.standard_normal((nB, P)).astype(np.float32)
    M = (rng.random((nB, P)) > 0.12).astype(np.float32)
    if missing_block:
        M[1] = 0.0  # alpha clamps at 1e-12
    return Y, M, D


def _jcfg(cfg):
    return jista.SparseProxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("alpha_mode", ["trace4", "specnorm"])
def test_compute_alpha_matches(alpha_mode):
    Y, M, D = _problem(0, nB=7, missing_block=True)
    cfg = SparseProxConfig(alpha_mode=alpha_mode, power_iters=30)
    ours = tista.compute_alpha(*_t(D, M), cfg).numpy()
    ref = np.asarray(jista.compute_alpha(jnp.asarray(D), jnp.asarray(M), _jcfg(cfg)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    assert ours[1] == np.float32(1e-12)


def test_nlm_matches():
    rng = np.random.default_rng(1)
    G = rng.standard_normal((6, 40)).astype(np.float32)
    h = rng.uniform(0.05, 2.0, size=6).astype(np.float32)
    ours = t_nlm(*_t(G, h)).numpy()
    ref = np.asarray(j_nlm(jnp.asarray(G), jnp.asarray(h)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize(
    "nB,alpha_mode,h_scale",
    [(5, "trace4", 1.0), (13, "trace4", 1.0), (5, "specnorm", 0.1), (13, "specnorm", 0.1)],
)
def test_plain_ista_matches_xla_and_pallas(nB, alpha_mode, h_scale):
    Y, M, D = _problem(nB, nB=nB, missing_block=True)
    cfg = SparseProxConfig(n_iter=12, alpha_mode=alpha_mode, h_scale=h_scale, power_iters=30)
    ours = tista.pnp_ista_blocks(*_t(Y, M, D), cfg).numpy()
    args = (jnp.asarray(Y), jnp.asarray(M), jnp.asarray(D), _jcfg(cfg))
    xla = np.asarray(jista.pnp_ista_blocks(*args))
    pallas = np.asarray(pnp_ista_blocks_pallas(*args, interpret=True))
    np.testing.assert_allclose(ours, xla, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, pallas, rtol=RTOL, atol=ATOL)
    assert np.all(ours[1] == 0.0)  # a fully missing block never moves


def test_plain_ista_bf16_operands_match():
    """bf16 operands, f32 accumulation: the same rounded operands on both
    sides, so the f32 tolerance still holds."""
    Y, M, D = _problem(2, nB=5)
    cfg = SparseProxConfig(n_iter=10, matmul_dtype="bfloat16")
    ours = tista.pnp_ista_blocks(*_t(Y, M, D), cfg).numpy()
    args = (jnp.asarray(Y), jnp.asarray(M), jnp.asarray(D), _jcfg(cfg))
    pallas = np.asarray(pnp_ista_blocks_pallas(*args, interpret=True))
    xla = np.asarray(jista.pnp_ista_blocks(*args))
    np.testing.assert_allclose(ours, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, xla, rtol=RTOL, atol=ATOL)
    f32 = tista.pnp_ista_blocks(*_t(Y, M, D), SparseProxConfig(n_iter=10)).numpy()
    assert 0 < np.abs(ours - f32).max() < 0.02 * np.abs(f32).max()


def test_sparse_prox_with_precomputed_alpha_matches():
    Y, M, D = _problem(3, nB=9)
    cfg = SparseProxConfig(n_iter=8)
    alpha = tista.compute_alpha(*_t(D, M), cfg)
    ours = tista.sparse_prox(*_t(Y, M, D), cfg, alpha=alpha).numpy()
    ref = np.asarray(
        jista.sparse_prox(
            jnp.asarray(Y), jnp.asarray(M), jnp.asarray(D), _jcfg(cfg),
            alpha=jnp.asarray(alpha.numpy()),
        )
    )
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=1e-5)


def test_wrapper_takes_plain_path_for_cpu_tensors():
    """sparse_prox takes the plain loop for CPU tensors; the kernel's
    wrapper takes CUDA tensors only."""
    Y, M, D = _problem(4, nB=3)
    cfg = SparseProxConfig(n_iter=5)
    before = ISTA_KERNEL.launches
    ours = tista.sparse_prox(*_t(Y, M, D), cfg)
    assert ISTA_KERNEL.launches == before
    assert torch.equal(ours, tista.pnp_ista_blocks(*_t(Y, M, D), cfg) @ torch.from_numpy(D).T)
    with pytest.raises(ValueError, match="CUDA device"):
        pnp_ista_blocks_fused(*_t(Y, M, D), cfg)
    assert ISTA_KERNEL.launches == before


def _loop_rounding(Ym, M, D, alpha, h, n_iter, rounded):
    """The plain loop with bf16 rounding of only the operands named in
    ``rounded`` (x, r for the residual, D)."""

    def rnd(t, name):
        return t.to(torch.bfloat16).float() if name in rounded else t

    Dm = rnd(D, "D")
    x = torch.zeros((Ym.shape[0], D.shape[1]))
    for _ in range(n_iter):
        resid = Ym - M * (rnd(x, "x") @ Dm.T)
        x = t_nlm(x + (rnd(resid, "r") @ Dm) / alpha[:, None], h)
    return x


@pytest.fixture(scope="module")
def main_path_blocks():
    """The first 13 blocks that the dip solve's first sparse prox gets."""
    sample = synthetic_sample(36, 36, 128, seed=0)
    cfg = dip_preset()
    consts = make_consts(sample, load_trained_dictionary(512), cfg, device="cpu")
    blocks = extract_blocks(consts.Y, block_grid((36 * 36, 128), cfg.block_size, cfg.stride))
    return blocks[:13], consts.mask_blocks[:13], consts.D, consts.alpha[:13]


@pytest.mark.parametrize("rounded", ["", "x", "r", "D", "xr", "xD", "rD", "xrD"])
def test_bf16_match_rejects_unrounded_operands(main_path_blocks, rounded):
    """A loop that rounds every operand matches the bf16 plain loop; one
    that skips any rounding (f32 is "") fails the bf16 match."""
    cfg = SparseProxConfig(n_iter=100, matmul_dtype="bfloat16")
    blocks, masks, D, alpha = main_path_blocks
    ref = tista.pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha)
    Ym, M, D, alpha, h = tista._prepare(blocks, masks, D, cfg, alpha)
    got = _loop_rounding(Ym, M, D, alpha, h, cfg.n_iter, rounded)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if rounded == "xrD":
        assert err < BF16_MATCH * scale
    else:
        assert err >= BF16_MATCH * scale


@pytest.mark.parametrize(
    "sparse,limit",
    [(dict(n_iter=100), BF16_MATCH), (dict(n_iter=80, alpha_mode="specnorm", h_scale=0.1), 1e-4)],
    ids=["dip", "lrs_pnp"],
)
def test_bf16_order_sensitivity(main_path_blocks, sparse, limit):
    """How far the bf16 plain loop moves when only the order of its sums
    changes (the rows of D permuted): the floor under any limit that holds a
    kernel to it.  At the dip settings it stays under the 1e-5 match; at the
    lrs_pnp settings (h_scale 0.1, NLM weights ten times as sharp) it does
    not, so kernel B1 is held to 1e-4 there (chip_smoke.py, test_torch_cuda.py)."""
    blocks, masks, D, _ = main_path_blocks
    cfg = SparseProxConfig(matmul_dtype="bfloat16", **sparse)
    alpha = tista.compute_alpha(D, masks, cfg)
    ref = tista.pnp_ista_blocks(blocks, masks, D, cfg, alpha=alpha)
    scale = float(ref.abs().max())
    worst = 0.0
    for seed in range(3):
        perm = torch.randperm(D.shape[0], generator=torch.Generator().manual_seed(seed))
        got = tista.pnp_ista_blocks(blocks[:, perm], masks[:, perm], D[perm], cfg, alpha=alpha)
        worst = max(worst, float((got - ref).abs().max()) / scale)
    print(f"bf16 order sensitivity {sparse}: {worst:.3e} of max|ref|")
    assert 0 < worst < limit


@pytest.mark.parametrize("denoiser", ["nlm_classic", "bm3d"])
def test_unported_denoisers_raise(denoiser):
    """The denoisers kernel B1 does not implement: its wrapper raises for
    them (before it looks at the device), and ``sparse_prox`` runs them in
    the plain loop, which matches the JAX package's XLA path (computed with
    subnormals flushed to zero, as XLA's CPU backend computes: at these
    bandwidths some NLM weights are subnormal, ``tests/test_torch_matlab.py``).
    On the card ``chip_smoke.py`` shows the same rule: no launch of B1 for
    them."""
    Y, M, D = _problem(5, nB=2)
    cfg = SparseProxConfig(n_iter=2, denoiser=denoiser)
    with pytest.raises(ValueError, match="nlm_fast denoiser only"):
        pnp_ista_blocks_fused(*_t(Y, M, D), cfg)
    with pytest.raises(ValueError, match="unknown denoiser"):
        tista.sparse_prox(*_t(Y, M, D), SparseProxConfig(n_iter=2, denoiser="tv"))
    assert torch.set_flush_denormal(True)
    try:
        ours = tista.sparse_prox(*_t(Y, M, D), cfg).numpy()
    finally:
        torch.set_flush_denormal(False)
    ref = np.asarray(jista.sparse_prox(jnp.asarray(Y), jnp.asarray(M), jnp.asarray(D), _jcfg(cfg)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Kernel B1's plan, without a card

MAX_SMEM = 232448  # dynamic shared memory one CTA may use on sm_90
PLAN_SHAPES = (
    [(nB, 1296, 512) for nB in (144, 13, 2304, 1, 10, 11, 77, 78, 150, 151)]
    + [(nB, 48, 32) for nB in (1, 5, 8, 13, 40)]
    + [(11, 100, 32), (11, 100, 300), (11, 1300, 512), (11, 1300, 600), (7, 50, 6), (9, 36, 30)]
    # the auto-dictionary's block 24 (P 576): the learned K, and K whose last
    # segment is empty (196) or 4 columns (200)
    + [(324, 576, 512), (324, 576, 196), (324, 576, 200), (1296, 576, 512)]
    # the streamed kernel: blocks 40, 48 and 52 at K 512 (f32), P 1296 at
    # K 768 to 1152, P 576 at K 1152 and 1280 (bf16 past 640 columns),
    # shapes the resident kernel refused; the column kernel past 1024
    # columns (f32) or 1280 (bf16)
    + [(324, 1600, 512), (4, 1700, 512), (4, 48, 700), (144, 1600, 512), (144, 2304, 512),
       (144, 2704, 512), (144, 1296, 768), (144, 1296, 1024), (144, 1296, 1152), (144, 576, 1152),
       (144, 576, 1280), (144, 1600, 768), (13, 7, 9000)]
    # nothing resident (f32, K 1000), short slices at P 7 and K 196, block 40
    # at the shapes of inpaint(block_size=40), K 1288 (bf16 past 1280)
    + [(7, 1296, 1000), (3, 7, 196), (132, 1600, 512), (9, 1296, 1030), (5, 576, 1288)]
    # the column kernel at chip_smoke.LONG_K_SHAPES (nB 144), the longest K at
    # P 1 (f32 and bf16) and at P 16 (bf16), and 2304 rows at P 576 / K 2048
    + [(144, 1296, 1152), (144, 576, 2048), (144, 256, 3000), (3, 1, 62908), (3, 16, 39308),
       (2304, 576, 2048)]
)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("nB,P,K", PLAN_SHAPES)
def test_plan_covers_every_row_and_column_once(nB, P, K, bf16):
    plan = plan_ista(nB, P, K, bf16)
    rows = [r for a, b in plan.row_chunks() for r in range(a, b)]
    assert rows == list(range(nB))
    assert all(0 < b - a <= plan.rows for a, b in plan.row_chunks())
    assert len(plan.p_slices()) == len(plan.k_segments()) == plan.cluster_size
    assert [p for a, b in plan.p_slices() for p in range(a, b)] == list(range(P))
    assert [k for a, b in plan.k_segments() for k in range(a, b)] == list(range(K))
    assert all(b - a <= plan.slice_rows for a, b in plan.p_slices())
    assert plan.seg % 4 == 0 and all(a % 4 == 0 for a, b in plan.k_segments() if b > a)
    assert plan.rows <= (64 if plan.tier == "panel" else 16 if bf16 or plan.tier == "streamed"
                         else 12 if plan.tier == "column" else 11)
    assert plan.smem_bytes <= MAX_SMEM
    assert 0 <= plan.resident_rows <= (P if plan.tier == "column" else plan.slice_rows)
    if plan.tier == "streamed":
        assert plan.resident_rows == plan.slice_rows or plan.resident_rows % plan.stage_rows == 0
        assert plan.smem_bytes == stream_smem_bytes(
            bf16, plan.rows, K, plan.seg, plan.resident_rows, plan.stages, plan.stage_rows)
        assert plan.stage_rows in ((16,) if bf16 else (8, 16)) and 0 <= plan.stages <= 3
        # a ring only for rows to stream, of as many stages as there are, up to 3
        streamed_stages = -(-plan.streamed_rows // plan.stage_rows)
        assert plan.stages == min(3, streamed_stages)
        assert K <= (1280 if bf16 else 1024)
        # with rows to stream, D copied once per launch: bf16 rounded, rows
        # padded to 16 values; f32 with K not a multiple of 4, padded to 8
        if not plan.stages:
            assert plan.scratch_floats == 0
        elif bf16:
            assert plan.scratch_floats == P * (-(-K // 16) * 16) // 2
        else:
            assert plan.scratch_floats == (P * (-(-K // 8) * 8) if K % 4 else 0)
        assert (plan.l2_bytes_per_iteration > 0) == (plan.stages > 0)
    elif plan.tier == "column":
        # CTA c owns seg columns (a multiple of 8 in f32, 16 in bf16) and a
        # slice of the residual's rows (a multiple of 4); rows of D[:, k_c]
        # resident: all P, or in bf16 whole 16-row tiles
        assert plan.seg % (16 if bf16 else 8) == 0 and plan.slice_rows % 4 == 0
        assert plan.resident_rows == P or not bf16 or plan.resident_rows % 16 == 0
        assert plan.smem_bytes == column_smem_bytes(bf16, plan.rows, P, plan.seg, plan.resident_rows)
        assert (plan.stage_rows, plan.stages) == (0, 0)
        # D copied once per launch: f32 with K not a multiple of 4 (rows
        # padded to 8), bf16 rounded with its transpose where rows stream
        assert plan.scratch_floats == column_scratch_floats(P, K, bf16, plan.resident_rows)
        assert (plan.scratch_floats > 0) == ((plan.resident_rows < P) if bf16 else K % 4 != 0)
        assert (plan.l2_bytes_per_iteration > 0) == (plan.resident_rows < P)
        if K <= (1280 if bf16 else 1024):
            # the streamed kernel's shared memory refused it, or its tiling is
            # predicted slower by more than the margin
            reasons = []
            streamed = _streamed_plan(nB, P, K, bf16, H100_RESIDENT_CLUSTERS, MAX_SMEM, reasons)
            if streamed is None:
                assert reasons and all(r.startswith("streamed") for r in reasons)
            else:
                assert predicted_ms(plan) < (1.0 - TIE_MARGIN) * predicted_ms(streamed)
    elif plan.tier == "panel":
        # 64-row panels past one wave of 16-row clusters, K <= 512, each
        # CTA's slice streamed in stages of 16 (f32) or 32 (bf16) rows from
        # images of 32 KB that the launch lays out
        assert nB > 16 * max(H100_RESIDENT_CLUSTERS.values()) and K <= 512
        assert plan.stage_rows == (32 if bf16 else 16) and plan.resident_rows == 0
        assert plan.stages == -(-plan.slice_rows // plan.stage_rows) and plan.seg % (16 if bf16 else 4) == 0
        assert plan.scratch_floats == plan.cluster_size * plan.stages * 8192
        assert plan.smem_bytes == ista_cuda.panel_smem_bytes(bf16, plan.seg)
    else:
        assert plan.tier == "resident"
        assert plan.resident_rows == plan.slice_rows and plan.scratch_floats == 0
    assert plan.cluster_size in H100_RESIDENT_CLUSTERS
    assert plan.resident == H100_RESIDENT_CLUSTERS[plan.cluster_size]
    assert plan.waves == -(-plan.n_clusters // plan.resident)
    assert plan == pick_plan(plan_candidates(nB, P, K, bf16))


def test_plan_at_the_main_shape():
    """f32: the slice of D is resident only in a cluster of 16, and 144 rows
    take two waves of 7 clusters; bf16: half the bytes fit a cluster of 8,
    and 15 clusters run at once."""
    f32 = plan_ista(144, 1296, 512, False)
    assert (f32.cluster_size, f32.rows, f32.n_clusters, f32.waves, f32.slice_rows, f32.seg) == (16, 11, 14, 2, 81, 32)
    bf16 = plan_ista(144, 1296, 512, True)
    assert (bf16.cluster_size, bf16.rows, bf16.n_clusters, bf16.waves, bf16.slice_rows, bf16.seg) == (8, 10, 15, 1, 162, 64)
    # a card that keeps other numbers of clusters resident gets another tiling
    other = plan_ista(144, 1296, 512, False, resident={8: 16, 16: 8})
    assert (other.rows, other.n_clusters, other.waves) == (9, 16, 2)


def test_plan_at_the_auto_dictionary_shape():
    """block_size 24 on the 36x36 cube: 324 blocks of P 576 against the
    learned K 512.  f32 fits its 72-row slice of D in a cluster of 8 (the
    first f32 tiling that is not a cluster of 16); bf16 takes the same
    cluster and, spread evenly over two waves, 11 rows too.  At K 196 the
    eighth CTA owns no column, at K 200 four."""
    f32 = plan_ista(324, 576, 512, False)
    assert (f32.cluster_size, f32.rows, f32.n_clusters, f32.waves, f32.slice_rows, f32.seg) == (8, 11, 30, 2, 72, 64)
    assert f32.smem_bytes == 205696
    bf16 = plan_ista(324, 576, 512, True)
    assert (bf16.cluster_size, bf16.rows, bf16.n_clusters, bf16.waves, bf16.slice_rows) == (8, 11, 30, 2, 72)
    assert bf16.smem_bytes == 131648
    for bf in (False, True):
        assert plan_ista(324, 576, 196, bf).k_segments()[-1] == (196, 196)
        assert plan_ista(324, 576, 200, bf).k_segments()[-1] == (196, 200)
    assert plan_ista(324, 576, 200, False).smem_bytes == 98944


@pytest.mark.parametrize(
    "nB,P,K,bf16,reason",
    [
        (4, 48, 5, False, "K >= 6"),
        (0, 48, 32, False, "nB >= 1"),
        (4, 1296, 2000, False, "past the TPU kernel's range: 21369792 B of VMEM"),
        # block 54 at K 512, the first block past the range (in bf16 the resident
        # kernel still takes it: block 56), and P 1 past its K
        (4, 2916, 512, False, "P=2916, K=512 with f32 operands: .*past the TPU kernel's range"),
        (4, 3136, 512, True, "P=3136, K=512 with bf16 operands: .*past the TPU kernel's range"),
        (4, 1, 62909, True, "past the TPU kernel's range"),
    ],
)
def test_plan_raises_with_the_reason(nB, P, K, bf16, reason):
    with pytest.raises(ValueError, match=reason):
        plan_ista(nB, P, K, bf16)


def test_plan_without_resident_clusters_raises():
    with pytest.raises(ValueError, match="keeps no such cluster resident"):
        plan_ista(4, 48, 32, False, resident={8: 0, 16: 0})


# A grid over the TPU kernel's range: blocks 1 to 52 and K from 6 to the
# largest the range takes at each P (the TPU wrapper's VMEM arithmetic at
# its smallest tile of 8 rows, lrs_pnp_dip_tpu/ops/ista_pallas.py:151-158).
SWEEP_P = [1, 4, 36, 144, 256, 576, 1024, 1296, 1600, 2304, 2704]


def _k_max(P):
    """The largest K in the range at P."""
    K = 6
    step = 1 << 16
    while step:
        if in_tpu_range(P, K + step):
            K += step
        step >>= 1
    return K


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plan_takes_every_shape_in_the_tpu_range(bf16):
    """Every (P, K) of the grid inside the range, at nB 1, 13 and 2304, gets
    a tiling that fits one CTA's shared memory; the largest K at each P is in
    the range and the next one is refused."""
    for P in SWEEP_P:
        k_max = _k_max(P)
        assert not in_tpu_range(P, k_max + 1)
        ks = sorted({6, 7, 32, 100, 512, 640, 641, 768, 1024, 1152, 2000, 4096, 16384, k_max} & set(range(6, k_max + 1)))
        for K in ks:
            for nB in (1, 13, 2304):
                plan = plan_ista(nB, P, K, bf16)
                assert plan.smem_bytes <= MAX_SMEM and plan.n_clusters * plan.rows >= nB
        with pytest.raises(ValueError, match="past the TPU kernel's range"):
            plan_ista(13, P, k_max + 1, bf16)


def test_the_range_reaches_the_stated_shapes():
    """At K 512 the range reaches block 52 (P 2704), at P 1296 K 1152, and
    D (twice) is the bulk of the VMEM the TPU wrapper counts."""
    assert in_tpu_range(2704, 512) and not in_tpu_range(2916, 512)
    assert 1152 <= _k_max(1296) < 1280
    assert tpu_vmem_bytes(1296, 2000) > 12 * 2**20


def test_plain_loop_matches_pallas_at_block_40():
    """The port's plain loop at P 1600 (block 40), K 512, nB 8, 3 iterations
    against the TPU kernel in interpret mode: the shape the streamed kernel
    takes on the card."""
    Y, M, D = _problem(40, P=1600, K=512, nB=8, missing_block=True)
    cfg = SparseProxConfig(n_iter=3)
    ours = tista.pnp_ista_blocks(*_t(Y, M, D), cfg).numpy()
    ref = np.asarray(pnp_ista_blocks_pallas(jnp.asarray(Y), jnp.asarray(M), jnp.asarray(D), _jcfg(cfg), interpret=True))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def _reflect(j, K):
    j = abs(j)
    return 2 * K - 2 - j if j >= K else j


def _nlm_segment(g_win, lo, k0, k1, K, nih):
    """The kernel's NLM on the columns [k0, k1) of rows whose gradient step
    is known on [lo, lo + g_win.shape[1]): reflect padding by index, weights
    7 exp(3 sum d^2 nih) forward and backward for delta 1..3, self weight 8."""
    idx = torch.tensor([[_reflect(k + j, K) - lo for j in range(-4, 5)] for k in range(k0, k1)])
    v = g_win[:, idx]  # (rows, k1 - k0, 9); v[..., 4 + j] is the padded g at k + j
    num = 8.0 * v[..., 4]
    den = torch.full_like(num, 8.0)
    for delta in (1, 2, 3):
        fwd = sum((v[..., 4 + u] - v[..., 4 + u + delta]) ** 2 for u in (-1, 0, 1))
        bwd = sum((v[..., 4 + u - delta] - v[..., 4 + u]) ** 2 for u in (-1, 0, 1))
        wf = 7.0 * torch.exp(3.0 * fwd * nih[:, None])
        wb = 7.0 * torch.exp(3.0 * bwd * nih[:, None])
        num = num + wf * v[..., 4 + delta] + wb * v[..., 4 - delta]
        den = den + wf + wb
    return num / den


def _reduce_and_denoise(plan, x, partial, ia, nih):
    """Step 3 on the rows of one cluster: each CTA sums the partial
    gradients of its columns and their halo in the ring order from its
    successor, adds the carried x and runs the NLM on its segment."""
    C, K = plan.cluster_size, plan.K
    x_new = torch.zeros_like(x)
    for rank, (k0, k1) in enumerate(plan.k_segments()):
        if k1 == k0:
            continue
        lo, hi = max(0, k0 - 4), min(K, k1 + 4)
        s = torch.zeros((x.shape[0], hi - lo))
        for i in range(C):  # ring order from the CTA's successor
            s = s + partial[(rank + 1 + i) % C][:, lo:hi]
        x_new[:, k0:k1] = _nlm_segment(x[:, lo:hi] + s * ia[:, None], lo, k0, k1, K, nih)
    return x_new


def _resident_step(plan, x, Ym, M, D, ia, nih, rnd):
    """One iteration of the resident kernels on the rows of one cluster:
    both products per CTA slice, then step 3."""
    partial = []
    for pa, pb in plan.p_slices():  # one CTA each
        Dc = rnd(D[pa:pb])
        resid = Ym[:, pa:pb] - M[:, pa:pb] * (rnd(x) @ Dc.T)
        partial.append(rnd(resid) @ Dc)
    return _reduce_and_denoise(plan, x, partial, ia, nih)


def _streamed_step(plan, x, Ym, M, D, ia, nih, rnd):
    """One iteration of the streamed kernel on the rows of one cluster: per
    CTA slice, stage by stage in row order (the resident stages, then the
    streamed ones, ``stage_rows`` rows each), product 1 of the stage, its
    residual, and its product 2 added into the CTA's partial gradient; then
    step 3."""
    S = plan.stage_rows
    partial = []
    for pa, pb in plan.p_slices():
        g = torch.zeros_like(x)
        for p in range(pa, pb, S):
            rows = slice(p, min(pb, p + S))
            Ds = rnd(D[rows])
            resid = rnd(Ym[:, rows] - M[:, rows] * (rnd(x) @ Ds.T))
            g = g + resid @ Ds
        partial.append(g)
    return _reduce_and_denoise(plan, x, partial, ia, nih)


def _column_step(plan, x, Ym, M, D, ia, nih, rnd):
    """One iteration of the column kernel on the rows of one cluster: per
    CTA c, the partial pred over its columns ``k_c``; for each CTA's slice
    of rows, the C partials summed in ring order from its successor and the
    residual (bf16: rounded once); per CTA, product 2 over all rows of D in
    groups whose sums are added in order (f32: ``column_groups`` runs of
    rows; bf16: the even and the odd 16-row steps where the CTA has at most
    16 tiles of 16 columns, else all rows in order), the gradient step of its
    columns, and the NLM on them with the halo of 4 from its neighbours'
    steps."""
    C, P, K = plan.cluster_size, plan.P, plan.K
    segments = plan.k_segments()
    partial = [rnd(x[:, a:b]) @ rnd(D[:, a:b]).T for a, b in segments]
    resid = torch.zeros_like(Ym)
    for c, (pa, pb) in enumerate(plan.p_slices()):
        s = torch.zeros((x.shape[0], pb - pa))
        for i in range(C):
            s = s + partial[(c + 1 + i) % C][:, pa:pb]
        resid[:, pa:pb] = rnd(Ym[:, pa:pb] - M[:, pa:pb] * s)
    g = torch.zeros_like(x)
    for a, b in segments:
        if not plan.bf16:
            n = -(-P // column_groups(plan.seg))
            groups = [torch.arange(p, min(P, p + n)) for p in range(0, P, n)]
        elif -(-(b - a) // 16) <= 16:
            groups = [torch.tensor([p for p in range(P) if p // 16 % 2 == h], dtype=torch.long) for h in (0, 1)]
        else:
            groups = [torch.arange(P)]
        s = torch.zeros((x.shape[0], b - a))
        for rows in groups:
            if plan.bf16:  # each half's mma chains cut every 8 steps of 16 rows
                part = torch.zeros_like(s)
                for c in range(0, len(rows), 128):
                    part = part + resid[:, rows[c:c + 128]] @ rnd(D[rows[c:c + 128], a:b])
                s = s + part
            else:
                s = s + resid[:, rows] @ rnd(D[rows, a:b])
        g[:, a:b] = x[:, a:b] + s * ia[:, None]
    x_new = torch.zeros_like(x)
    for a, b in segments:
        if b > a:
            lo, hi = max(0, a - 4), min(K, b + 4)
            x_new[:, a:b] = _nlm_segment(g[:, lo:hi], lo, a, b, K, nih)
    return x_new


def _panel_product1(x, Ds, bf16):
    """pred = x Ds^T as the panel kernels sum it.  f32: eight shares of K,
    share s the float4 columns q with q % 8 == s, each share's columns in
    order, then the shares added by the butterfly (xor 1, 2, 4); bf16: the
    two warpgroups' wgmma chains over the halves of the k steps of 16, their
    sums added."""
    K = x.shape[1]
    if bf16:
        c = 16 * -(-K // 32)  # the two warpgroups' halves of the k steps of 16
        return x[:, :c] @ Ds[:, :c].T + x[:, c:] @ Ds[:, c:].T
    shares = []
    for sh in range(8):
        acc = torch.zeros((x.shape[0], Ds.shape[0]))
        for q in range(sh, -(-K // 4), 8):
            for k in range(4 * q, min(K, 4 * q + 4)):
                acc = acc + x[:, k:k + 1] * Ds[None, :, k]
        shares.append(acc)
    s = shares
    return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]))


def _panel_step(plan, x, Ym, M, D, ia, nih, rnd):
    """One iteration of the panel kernels on the rows of one cluster (a
    panel): per CTA slice, stage by stage (``stage_rows`` rows, the last
    stages padded with zero rows of D), product 1 of the stage in the
    kernel's order (_panel_product1), its residual (bf16: rounded) and its
    product 2 added into the slice's partial gradient (f32: row by row of
    the stage; bf16: the stage's wgmma steps, not cut); then step 3, the
    partials summed in ring order from each CTA's successor."""
    S = plan.stage_rows
    partial = []
    for pa, pb in plan.p_slices():
        g = torch.zeros_like(x)
        for p in range(pa, pa + plan.stages * S, S):
            rows = slice(p, min(pb, p + S))
            if rows.stop <= rows.start:
                continue  # zero rows of D: nothing added
            Ds = rnd(D[rows])
            resid = rnd(Ym[:, rows] - M[:, rows] * _panel_product1(rnd(x), Ds, plan.bf16))
            if plan.bf16:
                g = g + resid @ Ds
            else:
                for j in range(Ds.shape[0]):
                    g = g + resid[:, j:j + 1] * Ds[j]
        partial.append(g)
    return _reduce_and_denoise(plan, x, partial, ia, nih)


_STEPS = {"resident": _resident_step, "streamed": _streamed_step, "column": _column_step, "panel": _panel_step}


def _emulate_plan(plan, blocks, masks, D, cfg, alpha):
    """pnp_ista_blocks as kernel B1 computes it under ``plan``."""
    Ym, M, D, alpha, h = tista._prepare(blocks, masks, D, cfg, alpha)
    rnd = (lambda t: t.to(torch.bfloat16).float()) if plan.bf16 else (lambda t: t)
    ia, nih = 1.0 / alpha, -1.0 / torch.clamp(h * h * 9.0, min=1e-30)
    out = torch.zeros((plan.nB, plan.K))
    step = _STEPS[plan.tier]
    for ra, rb in plan.row_chunks():
        x = torch.zeros((rb - ra, plan.K))
        for _ in range(cfg.n_iter):
            x = step(plan, x, Ym[ra:rb], M[ra:rb], D, ia[ra:rb], nih[ra:rb], rnd)
        out[ra:rb] = x
    return out


# Small swept shapes that the least predicted time moves off the first tier
# that takes them, and the tier it moves them to: the column tier over the
# resident one (f32, K 3000 at P 16) and over the streamed one (f32 at P
# 1700, K 30), the streamed tier over the resident one (f32, 166 rows of P
# 48: one wave of 12 rows per cluster against two waves; bf16 at P 100, K
# 300).  bf16 at P 144, K 1152 stays on the streamed tier: no sweep timed it,
# and the column tier is predicted 4% faster, inside the fits' error.
MOVED_TO = {
    (3, 16, 3000, False): "column",
    (9, 1700, 30, False): "column",
    (40, 144, 1152, True): "streamed",
    (166, 48, 32, False): "streamed",
    (11, 100, 300, True): "streamed",
}


def _forced_plan(nB, P, K, bf16, tier, resident_rows):
    """The plan of ``tier`` with ``resident_rows`` rows of each slice resident
    (clusters of 8): the shared-memory limit set so that just these fit."""
    clusters = {8: 15, 16: 0}
    if tier == "column":
        first = _column_plan(nB, P, K, bf16, clusters, MAX_SMEM, [])
        limit = column_smem_bytes(bf16, first.rows, P, first.seg, resident_rows)
        plan = _column_plan(nB, P, K, bf16, clusters, limit, [])
    else:
        first = _streamed_plan(nB, P, K, bf16, clusters, MAX_SMEM, [])
        S = first.stage_rows
        stages = min(3, -(-(first.slice_rows - resident_rows) // S))
        limit = stream_smem_bytes(bf16, first.rows, K, first.seg, resident_rows, stages, S)
        plan = _streamed_plan(nB, P, K, bf16, clusters, limit, [])
    assert plan is not None
    return plan


@pytest.mark.parametrize(
    "nB,P,K,bf16,resident,forced",
    [
        (5, 48, 32, False, H100_RESIDENT_CLUSTERS, None),
        (13, 48, 32, False, {8: 1, 16: 1}, None),  # 7 rows per cluster, two clusters
        (7, 50, 6, False, H100_RESIDENT_CLUSTERS, None),  # the narrowest K: segments of 4 and 2 columns
        (9, 36, 30, False, {8: 2, 16: 1}, None),  # K not a multiple of 4
        (6, 100, 300, False, H100_RESIDENT_CLUSTERS, None),  # a short last segment
        (13, 48, 32, True, {8: 1, 16: 1}, None),
        (5, 576, 196, False, H100_RESIDENT_CLUSTERS, None),  # the eighth CTA owns no column
        (5, 576, 200, True, H100_RESIDENT_CLUSTERS, None),  # the eighth CTA owns 4, its halo reflects
        # the streamed kernel (shapes the resident kernel refuses, or forced
        # with a shared-memory limit that keeps the given rows of each slice
        # resident): f32 at P 1600 (slices of 200 rows: 32 resident, 168
        # through a ring of 3 stages of 16, the last of 8 rows), bf16 past 640
        # columns (slices of 150: 16 resident, 134 in 9 stages of 16 through a
        # ring of 3, the last of 6), nothing resident with K not a multiple of 4, a bf16
        # slice wholly resident past 640 columns, P 7 (the last CTA owns no
        # row) at K 196 (and no column)
        (3, 1600, 40, False, H100_RESIDENT_CLUSTERS, ("streamed", 32)),
        (3, 1200, 700, True, H100_RESIDENT_CLUSTERS, ("streamed", 16)),
        (9, 1700, 30, False, H100_RESIDENT_CLUSTERS, ("streamed", 0)),
        (3, 200, 700, True, H100_RESIDENT_CLUSTERS, None),
        (3, 7, 196, True, H100_RESIDENT_CLUSTERS, ("streamed", 1)),
        (4, 600, 1024, False, H100_RESIDENT_CLUSTERS, ("streamed", 0)),
        # the column kernel: nothing resident (f32, 128 columns per CTA), 12
        # of 20 rows resident past 1024 columns, bf16 with one 16-row tile
        # resident and K past 1280, P 7 (the last CTAs own no rows of the
        # residual) at K 196 (the eighth CTA no column), and K past 1280 in
        # bf16 with all of D[:, k_c] resident
        (2, 20, 1000, False, H100_RESIDENT_CLUSTERS, ("column", 0)),
        (2, 20, 1100, False, H100_RESIDENT_CLUSTERS, ("column", 12)),
        (3, 40, 1400, True, H100_RESIDENT_CLUSTERS, ("column", 16)),
        (3, 7, 196, True, H100_RESIDENT_CLUSTERS, ("column", 7)),
        (5, 100, 1300, True, H100_RESIDENT_CLUSTERS, None),
        # shapes the least predicted time moves off the first tier that takes
        # them, and one it keeps there (MOVED_TO)
        (3, 16, 3000, False, H100_RESIDENT_CLUSTERS, None),
        (9, 1700, 30, False, H100_RESIDENT_CLUSTERS, None),
        (40, 144, 1152, True, H100_RESIDENT_CLUSTERS, None),
        (166, 48, 32, False, H100_RESIDENT_CLUSTERS, None),
        (11, 100, 300, True, H100_RESIDENT_CLUSTERS, None),
    ],
)
def test_plan_emulation_matches_plain_loop(nB, P, K, bf16, resident, forced):
    Y, M, D = _problem(nB + K, P=P, K=K, nB=nB, missing_block=True)
    cfg = SparseProxConfig(n_iter=8, matmul_dtype="bfloat16" if bf16 else "float32")
    if forced:
        plan = _forced_plan(nB, P, K, bf16, *forced)
        assert (plan.tier, plan.resident_rows) == forced
    else:
        plan = plan_ista(nB, P, K, bf16, resident=resident)
        assert plan.tier == MOVED_TO.get((nB, P, K, bf16), plan.tier)
    if plan.tier == "streamed" and forced:
        assert plan.stages == min(3, -(-plan.streamed_rows // plan.stage_rows)) > 0 or P == 7
    ref = tista.pnp_ista_blocks(*_t(Y, M, D), cfg)
    got = _emulate_plan(plan, *_t(Y, M, D), cfg, None)
    if bf16:  # the order of the sums flips an operand's rounding now and then
        assert float((got - ref).abs().max()) < BF16_MATCH * float(ref.abs().max())
    else:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    assert torch.all(got[1] == 0.0)  # a fully missing block never moves


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_column_emulation_matches_pallas(bf16):
    """A long-K shape on the column tier (nB 8, P 64, K 1100, 10
    iterations): the port's plain loop and the column kernel's order of sums
    against the TPU kernel in interpret mode, at the module's f32 tolerance
    (rtol 1e-4 / atol 1e-6) or, in bf16, the plain loop at it and the
    emulation within BF16_MATCH of max|ref| (its order flips a rounding now
    and then).  In f32 the plan picks the column tier over the resident one;
    in bf16 it keeps the streamed tier, so the column tiling is taken from
    _column_plan."""
    Y, M, D = _problem(1100, P=64, K=1100, nB=8, missing_block=True)
    cfg = SparseProxConfig(n_iter=10, matmul_dtype="bfloat16" if bf16 else "float32")
    plan = _column_plan(8, 64, 1100, bf16, H100_RESIDENT_CLUSTERS, MAX_SMEM, [])
    assert plan.tier == "column" and plan_ista(8, 64, 1100, bf16).tier == ("streamed" if bf16 else "column")
    ref = np.asarray(pnp_ista_blocks_pallas(jnp.asarray(Y), jnp.asarray(M), jnp.asarray(D), _jcfg(cfg),
                                            interpret=True))
    plain = tista.pnp_ista_blocks(*_t(Y, M, D), cfg).numpy()
    got = _emulate_plan(plan, *_t(Y, M, D), cfg, None).numpy()
    np.testing.assert_allclose(plain, ref, rtol=RTOL, atol=ATOL)
    if bf16:
        assert np.abs(got - ref).max() < BF16_MATCH * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert np.all(got[1] == 0.0)


# (nB, P, K, bf16) -> (tier, C, R, clusters, slice rows, seg, shared memory,
# resident rows, stage rows, stages) on an H100, as the resident and streamed
# tiers planned them before the column tier took the long-K tail: the main
# shape, the auto-dictionary's, chip_smoke.WIDE_SHAPES, nB 240, 2304 and 13;
# since the plan picks the least predicted time, P 1296 / K 1024 in f32 and
# P 576 / K 1152 in both types take the column tier, and block 40 at nB 240
# in bf16 the streamed tier (one wave of clusters of 8 against three); since
# the panel tier, nB 2304 takes 3 waves of 64-row panels in clusters of 8.
FIXED_PLANS = {
    (144, 1296, 512, False): ("resident", 16, 11, 14, 81, 32, 225056, 81, 0, 0),
    (144, 1296, 512, True): ("resident", 8, 10, 15, 162, 64, 231616, 162, 0, 0),
    (324, 576, 512, False): ("resident", 8, 11, 30, 72, 64, 205696, 72, 0, 0),
    (324, 576, 512, True): ("resident", 8, 11, 30, 72, 64, 131648, 72, 0, 0),
    (144, 1600, 512, False): ("streamed", 8, 10, 15, 200, 64, 221808, 32, 16, 3),
    (144, 1600, 512, True): ("resident", 16, 11, 14, 100, 32, 162784, 100, 0, 0),
    (144, 2304, 512, False): ("streamed", 8, 10, 15, 288, 64, 221808, 32, 16, 3),
    (144, 2304, 512, True): ("resident", 16, 11, 14, 144, 32, 197088, 144, 0, 0),
    (144, 2704, 512, False): ("streamed", 8, 10, 15, 338, 64, 221808, 32, 16, 3),
    (144, 2704, 512, True): ("resident", 16, 11, 14, 169, 32, 231392, 169, 0, 0),
    (144, 1296, 1024, False): ("column", 8, 10, 15, 164, 128, 231968, 262, 0, 0),
    (144, 1296, 1024, True): ("streamed", 8, 10, 15, 162, 128, 226480, 32, 16, 3),
    (144, 576, 1152, False): ("column", 8, 10, 15, 72, 144, 232288, 234, 0, 0),
    (144, 576, 1152, True): ("column", 8, 10, 15, 72, 144, 228800, 560, 0, 0),
    (240, 1600, 512, False): ("streamed", 8, 16, 15, 200, 64, 208304, 16, 16, 3),
    (240, 1600, 512, True): ("streamed", 8, 16, 15, 200, 64, 225968, 128, 16, 3),
    (240, 1296, 1024, False): ("streamed", 8, 16, 15, 162, 128, 231344, 8, 8, 3),
    (240, 1296, 1024, True): ("streamed", 8, 16, 15, 162, 128, 199600, 16, 16, 3),
    (2304, 1296, 512, False): ("panel", 8, 52, 45, 162, 64, 223768, 0, 16, 11),
    (2304, 1296, 512, True): ("panel", 8, 52, 45, 162, 64, 227872, 0, 32, 6),
    (13, 1296, 512, False): ("resident", 16, 2, 7, 81, 32, 199424, 81, 0, 0),
    (13, 1296, 512, True): ("resident", 8, 1, 13, 162, 64, 208288, 162, 0, 0),
}


@pytest.mark.parametrize("shape", list(FIXED_PLANS), ids=lambda s: "nB{}-P{}-K{}-{}".format(*s[:3], "bf16" if s[3] else "f32"))
def test_resident_and_streamed_plans_are_unchanged(shape):
    p = plan_ista(*shape)
    assert (p.tier, p.cluster_size, p.rows, p.n_clusters, p.slice_rows, p.seg, p.smem_bytes, p.resident_rows,
            p.stage_rows, p.stages) == FIXED_PLANS[shape]


def test_plan_at_the_long_k_shapes():
    """chip_smoke.LONG_K_SHAPES at nB 144 on an H100: one wave of 15
    clusters of 8 with 10 rows each (clusters of 16 would take two waves),
    each CTA a column slice of D with the rows that fit resident, the rest
    read from L2 twice per iteration; P 256 / K 3000 at nB 13 keeps all of
    D[:, k_c] resident in clusters of 16."""
    got = {}
    for P, K, bf16 in ((1296, 1152, False), (576, 2048, False), (576, 2048, True), (256, 3000, False),
                       (256, 3000, True)):
        plan = plan_ista(144, P, K, bf16)
        got[(P, K, bf16)] = (plan.tier, plan.cluster_size, plan.rows, plan.n_clusters, plan.waves, plan.seg,
                             plan.resident_rows)
        # the rows past the resident ones, once per product; each CTA's columns padded to 16 in bf16
        cols = -(-K // 16) * 16 if bf16 else K
        assert plan.l2_bytes_per_iteration == 2 * (P - plan.resident_rows) * cols * (2 if bf16 else 4)
    assert got == {
        (1296, 1152, False): ("column", 8, 10, 15, 1, 144, 234),
        (576, 2048, False): ("column", 8, 10, 15, 1, 256, 122),
        (576, 2048, True): ("column", 8, 10, 15, 1, 256, 304),
        (256, 3000, False): ("column", 8, 10, 15, 1, 376, 81),
        (256, 3000, True): ("column", 8, 10, 15, 1, 384, 208),
    }
    small = plan_ista(13, 256, 3000, False)
    assert (small.tier, small.cluster_size, small.rows, small.resident_rows, small.l2_bytes_per_iteration) == (
        "column", 16, 2, 256, 0)


def test_plan_tiers_at_the_streamed_shapes():
    """Which tier and tiling each shape of chip_smoke.WIDE_SHAPES gets on an
    H100 (nB 144), and the bytes of D its clusters stream per iteration:
    one wave of clusters of 8 everywhere (on the card it beat two waves of
    clusters of 16, even at P 576 / K 1152 in bf16, where those hold the
    whole slice); f32 at K 512 in stages of 16 rows with two of them
    resident, bf16 at K 1024 in stages of 16 with two resident; a ring of
    three stages.  P 1296 / K 1024 in f32 and P 576 / K 1152 in bf16 take
    the column tier, predicted (and timed) faster; their streamed tilings
    keep one resident stage of 8 and of 16 rows.  K past the streamed
    kernel's columns takes the column tier."""
    got = {}
    for P, K, bf16 in ((1600, 512, False), (2304, 512, False), (2704, 512, False), (1296, 1024, False),
                       (1296, 1024, True), (576, 1152, True)):
        plan = plan_ista(144, P, K, bf16)
        got[(P, K, bf16)] = (plan.tier, plan.cluster_size, plan.waves, plan.resident_rows, plan.stage_rows,
                             plan.stages)
    assert got == {
        (1600, 512, False): ("streamed", 8, 1, 32, 16, 3),
        (2304, 512, False): ("streamed", 8, 1, 32, 16, 3),
        (2704, 512, False): ("streamed", 8, 1, 32, 16, 3),
        (1296, 1024, False): ("column", 8, 1, 262, 0, 0),
        (1296, 1024, True): ("streamed", 8, 1, 32, 16, 3),
        (576, 1152, True): ("column", 8, 1, 560, 0, 0),
    }
    streamed = {(P, K, bf16): _streamed_plan(144, P, K, bf16, H100_RESIDENT_CLUSTERS, MAX_SMEM, [])
                for P, K, bf16 in ((1296, 1024, False), (576, 1152, True))}
    assert [(p.cluster_size, p.waves, p.resident_rows, p.stage_rows, p.stages) for p in streamed.values()] == [
        (8, 1, 8, 8, 3), (8, 1, 16, 16, 3)]
    # block 40: 8 CTAs stream the 168 rows of 512 floats past their 32 resident ones once per iteration
    assert plan_ista(144, 1600, 512, False).l2_bytes_per_iteration == 8 * 168 * 512 * 4
    # bf16 rows come from the rounded copy: 1152 values of 2 bytes
    assert streamed[(576, 1152, True)].l2_bytes_per_iteration == 8 * (72 - 16) * 1152 * 2
    assert plan_ista(13, 1296, 1152, False).tier == "column"
    assert plan_ista(13, 7, 9000, True).tier == "column"


# chip_smoke.TIER_SHAPES -> (the tiers of plan_candidates, in order; the
# pick of plan_ista on an H100 as (tier, C, R, waves)).  The sweeps of
# scripts/time_b1.py --tiers timed every candidate; the pick was within 5% of
# the fastest in every call (PERF.md section 6, "B1 across its tiers").  Past
# 240 rows the panel tier offers clusters of 8 and of 16; it takes nB 576,
# 1152 and 2304 at P 1296 in both types and nB 1296 at P 576 in bf16.
TIER_PICKS = {
    (144, 1296, 512, False): (("resident", "streamed", "column"), ("resident", 16, 11, 2)),
    (144, 1296, 512, True): (("resident", "streamed", "column"), ("resident", 8, 10, 1)),
    (72, 1296, 512, False): (("resident", "streamed", "column"), ("resident", 16, 11, 1)),
    (72, 1296, 512, True): (("resident", "streamed", "column"), ("resident", 8, 5, 1)),
    (288, 1296, 512, False): (("resident", "streamed", "column", "panel", "panel"), ("resident", 16, 11, 4)),
    (288, 1296, 512, True): (("resident", "streamed", "column", "panel", "panel"), ("resident", 8, 10, 2)),
    (576, 1296, 512, False): (("resident", "streamed", "column", "panel", "panel"), ("panel", 8, 39, 1)),
    (576, 1296, 512, True): (("resident", "streamed", "column", "panel", "panel"), ("panel", 8, 39, 1)),
    (1152, 1296, 512, False): (("resident", "streamed", "column", "panel", "panel"), ("panel", 16, 55, 3)),
    (1152, 1296, 512, True): (("resident", "streamed", "column", "panel", "panel"), ("panel", 8, 39, 2)),
    (2304, 1296, 512, False): (("resident", "streamed", "column", "panel", "panel"), ("panel", 8, 52, 3)),
    (2304, 1296, 512, True): (("resident", "streamed", "column", "panel", "panel"), ("panel", 8, 52, 3)),
    (324, 576, 512, False): (("resident", "streamed", "column", "panel", "panel"), ("resident", 8, 11, 2)),
    (324, 576, 512, True): (("resident", "streamed", "column", "panel", "panel"), ("resident", 8, 11, 2)),
    (1296, 576, 512, False): (("resident", "streamed", "column", "panel", "panel"), ("resident", 8, 11, 8)),
    (1296, 576, 512, True): (("resident", "streamed", "column", "panel", "panel"), ("panel", 8, 44, 2)),
    (132, 1600, 512, False): (("streamed", "column"), ("streamed", 8, 9, 1)),
    (132, 1600, 512, True): (("resident", "streamed", "column"), ("resident", 16, 10, 2)),
    (144, 2304, 512, False): (("streamed", "column"), ("streamed", 8, 10, 1)),
    (144, 2304, 512, True): (("resident", "streamed", "column"), ("resident", 16, 11, 2)),
    (144, 2704, 512, False): (("streamed", "column"), ("streamed", 8, 10, 1)),
    (144, 2704, 512, True): (("resident", "streamed", "column"), ("resident", 16, 11, 2)),
    (144, 1296, 1024, False): (("streamed", "column"), ("column", 8, 10, 1)),
    (144, 1296, 1024, True): (("streamed", "column"), ("streamed", 8, 10, 1)),
    (144, 576, 1152, False): (("resident", "column"), ("column", 8, 10, 1)),
    (144, 576, 1152, True): (("streamed", "column"), ("column", 8, 10, 1)),
    (144, 1296, 1152, True): (("streamed", "column"), ("streamed", 8, 10, 1)),
}


def _shape_id(shape):
    return "nB{}-P{}-K{}-{}".format(*shape[:3], "bf16" if shape[3] else "f32")


@pytest.mark.parametrize("shape", list(TIER_PICKS), ids=_shape_id)
def test_plan_picks_the_least_cost_tier(shape):
    """At each shape of the sweep: the tiers that take it, in order, and the
    plan's pick, which has the least predicted time of them or is an
    earlier tier predicted within TIE_MARGIN of it."""
    tiers, pick = TIER_PICKS[shape]
    plans = plan_candidates(*shape)
    assert tuple(p.tier for p in plans) == tiers
    plan = plan_ista(*shape)
    assert plan in plans and (plan.tier, plan.cluster_size, plan.rows, plan.waves) == pick
    fastest = min(predicted_ms(p) for p in plans)
    assert predicted_ms(plan) * (1.0 - TIE_MARGIN) <= fastest
    assert all(predicted_ms(p) >= (1.0 - TIE_MARGIN) * predicted_ms(plan) for p in plans[plans.index(plan) + 1:])


def test_plan_ties_keep_the_earlier_tier(monkeypatch):
    """Predicted ties keep plan_candidates' order (resident, streamed,
    column: the order the plan took before it compared times); a later tier
    replaces an earlier one only when predicted faster by more than
    TIE_MARGIN at a swept shape, by more than the fits' error elsewhere."""
    shape = (144, 576, 1152, False)
    first, later = plan_candidates(*shape)
    assert (first.tier, later.tier) == ("resident", "column")
    for gain, picked in ((0.0, first), (TIE_MARGIN / 2, first), (2 * TIE_MARGIN, later)):
        monkeypatch.setattr(ista_cuda, "predicted_ms", lambda p, n_iter=100, g=gain: 1.0 - g * (p == later))
        assert plan_ista(*shape) == picked
    # off the swept shapes a later tier must win by more than the larger
    # fit error of the two tiers' groups
    shape = (40, 576, 1152, False)
    assert shape not in ista_cuda.SWEPT_SHAPES
    first, later = plan_candidates(*shape)
    error = max(ista_cuda._FIT_ERROR["resident", False], ista_cuda._FIT_ERROR["column", False])
    for gain, picked in ((2 * TIE_MARGIN, first), (error - 0.01, first), (error + 0.01, later)):
        monkeypatch.setattr(ista_cuda, "predicted_ms", lambda p, n_iter=100, g=gain: 1.0 - g * (p == later))
        assert plan_ista(*shape) == picked
    monkeypatch.setattr(ista_cuda, "predicted_ms", lambda p, n_iter=100: 1.0)
    for shape in TIER_PICKS:
        assert plan_ista(*shape) == plan_candidates(*shape)[0]


@pytest.mark.parametrize("shape", [(144, 1296, 512, False), (144, 1296, 512, True), (144, 576, 1152, False),
                                   (144, 1296, 1024, True)], ids=_shape_id)
def test_predicted_time_grows_with_waves(shape):
    """Inside a tier the predicted time is one wave's times the waves, and
    grows with n_iter in proportion."""
    for plan in plan_candidates(*shape):
        times = [predicted_ms(dataclasses.replace(plan, n_clusters=w * plan.resident)) for w in (1, 2, 3, 5)]
        assert times[0] > 0 and times == pytest.approx([w * times[0] for w in (1, 2, 3, 5)])
        assert predicted_ms(plan, 80) == pytest.approx(0.8 * predicted_ms(plan))


def test_cost_constants_are_the_fit_of_the_sweeps():
    """The constants of predicted_ms and each group's largest error are what
    scripts/fit_b1_plan.py fits to the committed sweeps (to 1e-3: another
    scipy may round a constant the other way), SWEPT_SHAPES are the shapes
    they timed, and with the constants every swept shape of every call
    picks within 5% of the fastest candidate timed in that call but one (2
    rows of P 36 at K 700 in f32, a 0.6 ms launch, in the calls that swept
    it: PERF.md)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "fit_b1_plan.py"
    spec = importlib.util.spec_from_file_location("fit_b1_plan", path)
    fit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fit)
    rows = fit.load([path.parent / "b1_tier_sweeps.jsonl"])
    table = fit.fit(rows)
    assert table.keys() == ista_cuda._COST_US.keys() == ista_cuda._FIT_ERROR.keys()
    for key, (coef, worst, _) in table.items():
        assert coef == pytest.approx(ista_cuda._COST_US[key], rel=1e-3, abs=1e-6)
        assert worst == pytest.approx(ista_cuda._FIT_ERROR[key], abs=1e-3)
    assert ista_cuda.SWEPT_SHAPES == {(p.nB, p.P, p.K, p.bf16) for _, p in rows}
    assert {miss[0][1:] for miss in fit.misses(rows)} == {(2, 36, 700, False)}


@pytest.mark.parametrize("shape", list(TIER_PICKS) + [(13, 48, 32, False), (240, 1600, 512, False)], ids=_shape_id)
def test_share_plan_keeps_each_rows_tiling(shape):
    """One rank's share of the rows under {patch: 2} (share_plan of the
    plan over all rows): the whole's tier, cluster size, slices, segments,
    stages and register tiles, every share row in a cluster, at most the
    whole's rows per cluster, the shared memory its tier lays out."""
    whole = plan_ista(*shape)
    for n in (-(-shape[0] // 2), 1):
        share = share_plan(whole, n)
        same = ("tier", "cluster_size", "slice_rows", "seg", "resident_rows", "stage_rows", "stages", "bf16")
        assert all(getattr(share, f) == getattr(whole, f) for f in same)
        assert tile_rows(share) == tile_rows(whole) and share.rows <= whole.rows
        assert [r for a, b in share.row_chunks() for r in range(a, b)] == list(range(n))
        assert share.smem_bytes == plan_smem_bytes(share) <= MAX_SMEM
    # the planners' own shared memory is what plan_smem_bytes lays out
    assert all(p.smem_bytes == plan_smem_bytes(p) for p in plan_candidates(*shape))


def test_kernel_plans_a_share_inside_shares_of():
    """FusedIstaKernel.plan (the card's resident clusters given, so that
    nothing is built): inside ``shares_of(144)`` 72 rows take the share of
    the plan at 144 (at P 576 / K 1152 in f32, the column tier's clusters of
    8, where 72 rows alone take clusters of 16); outside it, and at 144 rows
    inside it, the plan of the shape."""
    kernel = FusedIstaKernel()
    kernel._resident = {False: dict(H100_RESIDENT_CLUSTERS), True: dict(H100_RESIDENT_CLUSTERS)}
    alone = kernel.plan(72, 576, 1152, False)
    assert (alone.tier, alone.cluster_size) == ("column", 16)
    with kernel.shares_of(144):
        share = kernel.plan(72, 576, 1152, False)
        assert kernel.plan(144, 576, 1152, False) == plan_ista(144, 576, 1152, False)
    assert share == share_plan(plan_ista(144, 576, 1152, False), 72) and share.cluster_size == 8
    assert kernel.plan(72, 576, 1152, False) == alone and kernel._whole is None


def _short_stages_in_fresh_slots(plan):
    """(CTA, slot, valid rows) of each short stage that is the first of its
    pass in its slot while rows of the slot past it lay under the partial
    gradient in the step 3 before: the rows that no bulk copy writes in
    the pass (csrc/ista.cu, make_stream_layout: the ring, then the partial
    gradient in its place)."""
    S = plan.stage_rows
    esz = 2 if plan.bf16 else 4
    kp = -(-plan.K // (16 if plan.bf16 else 8)) * (16 if plan.bf16 else 8)
    slot_bytes, row_bytes = S * (kp + (8 if plan.bf16 else 4)) * esz, (kp + (8 if plan.bf16 else 4)) * esz
    g_bytes = plan.rows * (kp + 8) * 4
    found = []
    for c, (pa, pb) in enumerate(plan.p_slices()):
        streamed = max(0, pb - pa - plan.resident_rows)
        for s in range(min(plan.stages, -(-streamed // S))):
            valid = min(S, streamed - s * S)
            if valid < S and s * slot_bytes + valid * row_bytes < g_bytes:
                found.append((c, s, valid))
    return found


@pytest.mark.parametrize("P,expected", [(400, (0, 2)), (529, (1, 3))], ids=["one-stage", "second-stage"])
def test_card_cases_stream_a_short_stage_into_a_fresh_slot(P, expected):
    """tests/test_torch_cuda.py's cases bf16-one-short-stage and
    bf16-short-second-stage (nB 144, K 1024, bf16: 10 rows per cluster)
    reach the rows of a ring slot that only the partial gradient wrote
    before: P 400 streams one stage of 2 rows per CTA into slot 0, P 529
    two stages, the second of 3 rows into slot 1 (which the partial
    gradient's 10 rows reach past slot 0).  The plan picks the column tier
    at both, so the card test forces this streamed tiling."""
    assert plan_ista(144, P, 1024, True).tier == "column"
    plan = _streamed_plan(144, P, 1024, True, H100_RESIDENT_CLUSTERS, MAX_SMEM, [])
    assert (plan.tier, plan.rows, plan.cluster_size, plan.resident_rows) == ("streamed", 10, 8, 48)
    found = _short_stages_in_fresh_slots(plan)
    assert (0, *expected) in found and all((slot, valid) == expected for c, slot, valid in found if c < 7)


class _OnCard:
    """Stands in for a CUDA tensor in the dispatch predicate, which reads
    ``is_cuda`` only."""

    is_cuda = True


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("denoiser", ["nlm_fast", "nlm_classic", "bm3d"])
def test_use_kernel_honours_backend(backend, denoiser):
    """``backend="xla"`` runs the plain loop on any device; ``"auto"`` and
    ``"pallas"`` take kernel B1 for CUDA tensors with nlm_fast; the other
    denoisers and CPU tensors always run the plain loop."""
    cfg = SparseProxConfig(backend=backend, denoiser=denoiser)
    assert tista.use_kernel(_OnCard(), cfg) == (backend != "xla" and denoiser == "nlm_fast")
    assert not tista.use_kernel(torch.zeros(2, 3), cfg)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        tista.use_kernel(torch.zeros(2, 3), SparseProxConfig(backend="triton"))


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
def test_sparse_prox_on_the_cpu_never_reaches_the_kernel(monkeypatch, backend):
    def refuse(*args, **kwargs):
        raise AssertionError("kernel B1's wrapper was called")

    monkeypatch.setattr(tista, "pnp_ista_blocks_fused", refuse)
    Y, M, D = _problem(3)
    cfg = SparseProxConfig(n_iter=3, backend=backend)
    out = tista.sparse_prox(*_t(Y, M, D), cfg)
    ref = tista.pnp_ista_blocks(*_t(Y, M, D), cfg) @ torch.from_numpy(D).T
    assert torch.equal(out, ref)


def test_plan_refusal_names_the_way_around():
    """Block 54 (P 2916) in f32, past the TPU kernel's range at K 512: the
    plan refuses and names backend="xla".  (Block 40 runs on the streamed
    kernel.)"""
    assert plan_ista(132, 1600, 512, False).streamed
    with pytest.raises(ValueError, match='backend="xla"'):
        plan_ista(132, 2916, 512, False)


@pytest.mark.parametrize("alpha_mode", ["trace4", "specnorm"])
def test_loop_without_a_group_is_the_loop_before_the_hook(alpha_mode):
    """With no process group the all_reduce hook is the identity: the loop
    equals, bit for bit, the loop written without it."""
    Y, M, D = _problem(5, missing_block=True)
    cfg = SparseProxConfig(n_iter=6, alpha_mode=alpha_mode, power_iters=7)
    Ym, Mt, Dt, alpha, h = tista._prepare(*_t(Y, M, D), cfg, None)
    denoise = tista._denoiser(cfg, h)
    x = torch.zeros((Ym.shape[0], Dt.shape[1]))
    for _ in range(cfg.n_iter):
        resid = Ym - Mt * (x @ Dt.T)
        x = denoise(x + (resid @ Dt) / alpha[:, None])
    assert torch.equal(tista.pnp_ista_blocks(*_t(Y, M, D), cfg, group=None), x)
    M_t, D_t = _t(M, D)
    if alpha_mode == "trace4":
        before = 4.0 * (M_t @ torch.sum(D_t * D_t, dim=1))
    else:
        v = torch.ones((M.shape[0], D.shape[1])) / (D.shape[1] ** 0.5)
        for _ in range(cfg.power_iters):
            u = (M_t * (v @ D_t.T)) @ D_t
            v = u / (torch.linalg.norm(u, dim=1, keepdim=True) + 1e-30)
        before = torch.sum(v * ((M_t * (v @ D_t.T)) @ D_t), dim=1)
    assert torch.equal(tista.compute_alpha(D_t, M_t, cfg), torch.clamp(before, min=1e-12))


# ---------------------------------------------------------------------------
# Kernel B1's panel tier (csrc/ista_panel.cuh): many rows, 64 per cluster


def _panels(nB, P, K, bf16, resident=H100_RESIDENT_CLUSTERS, smem_limit=MAX_SMEM, reasons=None):
    return [p for p in plan_candidates(nB, P, K, bf16, resident, smem_limit, reasons) if p.tier == "panel"]


def test_panel_tilings_at_many_rows():
    """nB 2304, P 1296, K 512 on an H100: the panel tier offers clusters of
    8 (45 clusters of 52 rows, 3 waves of 15) and of 16 (42 of 55, 6 waves
    of 7), after the other tiers; each CTA streams its 162 (81) rows of D as
    stages of 16 rows in f32, 32 in bf16, each stage an image of 32 KB in
    device memory, once per iteration; each CTA owns 64 (32) columns of x."""
    got = {}
    for bf16 in (False, True):
        assert [p.tier for p in plan_candidates(2304, 1296, 512, bf16)][-2:] == ["panel", "panel"]
        for p in _panels(2304, 1296, 512, bf16):
            got[bf16, p.cluster_size] = (p.rows, p.n_clusters, p.waves, p.slice_rows, p.seg, p.stage_rows, p.stages,
                                         p.smem_bytes, p.resident_rows)
            assert p.scratch_floats == p.cluster_size * p.stages * 8192 == ista_cuda.panel_scratch_floats(
                p.cluster_size, p.stages)
            assert p.l2_bytes_per_iteration == 4 * p.scratch_floats and tile_rows(p) == 64 and p.streamed
            assert p.smem_bytes == ista_cuda.panel_smem_bytes(bf16, p.seg) == plan_smem_bytes(p) <= MAX_SMEM
            assert ista_cuda.kernel_name(p) == f"pnp_ista_panel_{'bf16' if bf16 else 'f32'}"
    assert got == {
        (False, 8): (52, 45, 3, 162, 64, 16, 11, 223768, 0),
        (False, 16): (55, 42, 6, 81, 32, 16, 6, 215576, 0),
        (True, 8): (52, 45, 3, 162, 64, 32, 6, 227872, 0),
        (True, 16): (55, 42, 6, 81, 32, 32, 3, 211488, 0),
    }


def test_panel_waves_follow_the_resident_clusters():
    """The panels spread the rows over as few waves of at most 64 rows as
    cover nB, for the clusters the card keeps resident: nB 1152 takes 2
    waves of 15 clusters of 8 (39 rows each) or 3 of 7 clusters of 16 (55);
    a card that keeps 16 clusters of 8 and 8 of 16 takes 1152 rows in 2
    waves of 36 rows a cluster, or 3 of 48."""
    got = [(p.cluster_size, p.rows, p.n_clusters, p.waves) for p in _panels(1152, 1296, 512, False)]
    assert got == [(8, 39, 30, 2), (16, 55, 21, 3)]
    other = _panels(1152, 1296, 512, False, resident={8: 16, 16: 8})
    assert [(p.rows, p.n_clusters, p.waves) for p in other] == [(36, 32, 2), (48, 24, 3)]
    for plan in _panels(1153, 1296, 512, True):
        assert [r for a, b in plan.row_chunks() for r in range(a, b)] == list(range(1153))
        assert plan.row_chunks()[-1][1] - plan.row_chunks()[-1][0] < plan.rows <= 64  # the last panel partly masked


@pytest.mark.parametrize(
    "nB,P,K,bf16,resident,smem_limit,reason",
    [
        (240, 1296, 512, False, H100_RESIDENT_CLUSTERS, MAX_SMEM,
         r"panel: nB=240 fits one wave of 16-row clusters \(240 rows\)"),
        (2304, 1296, 640, True, H100_RESIDENT_CLUSTERS, MAX_SMEM, "panel: K=640 is past its 512 columns"),
        (2304, 576, 1152, False, H100_RESIDENT_CLUSTERS, MAX_SMEM, "panel: K=1152 is past its 512 columns"),
        (2304, 1296, 512, False, {8: 15, 16: 0}, MAX_SMEM, "panel, cluster 16: the card keeps no such cluster"),
        (2304, 1296, 512, False, H100_RESIDENT_CLUSTERS, 220000,
         r"panel, cluster 8: 223768 B of shared memory \(> 220000\)"),
    ],
    ids=["one-wave", "bf16-K640", "K1152", "no-clusters-of-16", "shared-memory"],
)
def test_panel_refuses_with_the_reason(nB, P, K, bf16, resident, smem_limit, reason):
    """Where the panel tier offers no tiling (or not every cluster size) the
    reasons say why: a launch that fits one wave of the other tiers' 16-row
    clusters, K past 512, a cluster size the card does not keep, shared
    memory."""
    import re

    reasons = []
    panels = _panels(nB, P, K, bf16, resident, smem_limit, reasons)
    assert any(re.match(reason, r) for r in reasons), reasons
    if reason.startswith("panel, cluster"):
        assert len(panels) == 1
    else:
        assert panels == []


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_panel_share_plan(bf16):
    """Under {patch: 2} each rank launches its 576 of 1152 rows as a share
    of the whole launch's panel tiling: the same clusters, slices, segments
    and stages, at most the whole's rows per cluster, over 64-row tiles."""
    for whole in _panels(1152, 1296, 512, bf16):
        share = share_plan(whole, 576)
        same = ("tier", "cluster_size", "slice_rows", "seg", "stage_rows", "stages", "smem_bytes", "bf16")
        assert all(getattr(share, f) == getattr(whole, f) for f in same)
        assert share.rows <= whole.rows and tile_rows(share) == 64 and share.scratch_floats == whole.scratch_floats
        assert [r for a, b in share.row_chunks() for r in range(a, b)] == list(range(576))


# (nB, P, K, resident clusters, C): two panels of 20 rows in clusters of 8
# (each CTA 13 rows of D, one stage); one panel of 41 of 64 rows in a
# cluster of 16 with K not a multiple of 4; P 7 under clusters of 8 (the
# eighth CTA owns no row of D) in two panels of 35.  A card that keeps 2
# clusters of 8 resident: the panel tier takes nB past 32.
PANEL_CASES = [(40, 100, 64, 8), (41, 48, 30, 16), (70, 7, 20, 8)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("nB,P,K,C", PANEL_CASES, ids=["C8", "C16-K30", "P7"])
def test_panel_emulation_matches_pallas(nB, P, K, C, bf16):
    """The panel kernels' order of sums (_panel_step: the P split, each
    stage's product 1 in eight shares added by a butterfly in f32 or in
    two wgmma chains over the halves of K in bf16, product 2 into the slice's partial
    gradient, the partials summed in ring order) against the TPU kernel in
    interpret mode and the JAX package's XLA loop, 10 iterations, at the
    module's f32 tolerance (rtol 1e-4 / atol 1e-6); in bf16 the port's plain
    loop at it and the emulation within BF16_MATCH of max|ref|, as for the
    column tier.  A fully missing block stays 0."""
    Y, M, D = _problem(nB + P + K, P=P, K=K, nB=nB, missing_block=True)
    cfg = SparseProxConfig(n_iter=10, matmul_dtype="bfloat16" if bf16 else "float32")
    plan = next(p for p in _panels(nB, P, K, bf16, resident={8: 2, 16: 1}) if p.cluster_size == C)
    if P == 7:
        assert plan.p_slices()[-1] == (7, 7)
    args = (jnp.asarray(Y), jnp.asarray(M), jnp.asarray(D), _jcfg(cfg))
    ref = np.asarray(pnp_ista_blocks_pallas(*args, interpret=True))
    xla = np.asarray(jista.pnp_ista_blocks(*args))
    plain = tista.pnp_ista_blocks(*_t(Y, M, D), cfg).numpy()
    got = _emulate_plan(plan, *_t(Y, M, D), cfg, None).numpy()
    np.testing.assert_allclose(plain, ref, rtol=RTOL, atol=ATOL)
    if bf16:
        assert np.abs(got - ref).max() < BF16_MATCH * np.abs(ref).max()
        assert np.abs(got - xla).max() < BF16_MATCH * np.abs(xla).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, xla, rtol=RTOL, atol=ATOL)
    assert np.all(got[1] == 0.0)
