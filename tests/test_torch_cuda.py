"""Kernel B1 on the card, against its plain PyTorch version, and the
lockstep engines' one launch per outer step.

These need an NVIDIA GPU (sm_90a) and ``nvcc``; without a card they skip.
This file imports nothing of JAX, so on the machine with the card it runs
without the repository's ``conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 rtol 1e-4 / atol 1e-5 (the kernel sums the products in
another order than cuBLAS, per slice of D and then across the cluster, and
multiplies by -1/(9h^2) where the plain NLM divides by 9h^2); bf16 operands
against the bf16 plain loop max |delta| < 1e-5 max|ref| (the same rounding,
in another order), and against the f32 plain loop max |delta| < 0.02
max|ref|, as in ``tests/test_ista_pallas.py``.  The tensor-core path meets
the same bf16 limits as rounded operands on the CUDA cores would: a product
of two bf16 values is exact in f32 on both.  Two launches on the same inputs
must agree bit for bit: the kernel has no atomics and sums in a fixed order.
"""

import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu_torch.data import synthetic_sample
from lrs_pnp_dip_tpu_torch.ops import (
    ISTA_KERNEL, compute_alpha, pnp_ista_blocks, pnp_ista_blocks_fused, svt_gram,
)
from lrs_pnp_dip_tpu_torch.ops.ista_cuda import _MAX_SMEM_BYTES, plan_candidates
from lrs_pnp_dip_tpu_torch.solvers import BatchedSolver, Solver
from lrs_pnp_dip_tpu_torch.utils.config import SolverConfig, SparseProxConfig

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _candidate(nB, P, K, bf16, tier):
    """The tiling of ``tier`` among plan_candidates on this card."""
    plans = plan_candidates(nB, P, K, bf16, ISTA_KERNEL.resident_clusters(bf16), _MAX_SMEM_BYTES)
    return next(p for p in plans if p.tier == tier)


def _problem(cuda, nB, P, K, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((P, K)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    Y = rng.standard_normal((nB, P)).astype(np.float32)
    M = (rng.random((nB, P)) > 0.12).astype(np.float32)
    M[min(1, nB - 1)] = 0.0  # a fully missing block
    return [torch.from_numpy(a).to(cuda) for a in (Y, M, D)]


@pytest.mark.parametrize("nB", [1, 5, 8, 13, 40])
@pytest.mark.parametrize("alpha_mode", ["trace4", "specnorm"])
def test_kernel_matches_plain_f32(cuda, nB, alpha_mode):
    Y, M, D = _problem(cuda, nB, P=48, K=32, seed=nB)
    cfg = SparseProxConfig(n_iter=15, alpha_mode=alpha_mode, h_scale=0.1 if alpha_mode == "specnorm" else 1.0)
    before = ISTA_KERNEL.launches
    got = pnp_ista_blocks_fused(Y, M, D, cfg)
    torch.cuda.synchronize()
    assert ISTA_KERNEL.launches == before + 1
    ref = pnp_ista_blocks(Y, M, D, cfg)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("K", [32, 300, 512, 600])
def test_kernel_matches_plain_odd_widths(cuda, K):
    """K past one pass of the column loops, and P not a multiple of 32."""
    Y, M, D = _problem(cuda, 11, P=1300 if K >= 512 else 100, K=K, seed=K)
    cfg = SparseProxConfig(n_iter=6)
    got = pnp_ista_blocks_fused(Y, M, D, cfg)
    torch.testing.assert_close(got, pnp_ista_blocks(Y, M, D, cfg), rtol=1e-4, atol=1e-5)


def test_kernel_bf16_operands_track_plain(cuda):
    Y, M, D = _problem(cuda, 13, P=48, K=32, seed=2)
    cfg = SparseProxConfig(n_iter=10, matmul_dtype="bfloat16")
    got = pnp_ista_blocks_fused(Y, M, D, cfg)
    ref = pnp_ista_blocks(Y, M, D, cfg)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) < 1e-5 * float(ref.abs().max())
    f32 = pnp_ista_blocks(Y, M, D, SparseProxConfig(n_iter=10))
    assert float((got - f32).abs().max()) < 0.02 * float(f32.abs().max())


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    Y, M, D = _problem(cuda, 4, P=48, K=32)
    cfg = SparseProxConfig(n_iter=2)
    with pytest.raises(ValueError, match="contiguous"):
        pnp_ista_blocks_fused(Y, M, D.T.contiguous().T, cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        pnp_ista_blocks_fused(Y, M, D.cpu(), cfg)
    with pytest.raises(ValueError, match="shape"):
        pnp_ista_blocks_fused(Y, M[:, :40].contiguous(), D, cfg)


def _order_sensitivity(Y, M, D, cfg, ref, alpha=None):
    """max |delta| of the bf16 plain loop against itself with the rows of D
    permuted: what a change in the order of the sums alone does."""
    worst = 0.0
    for seed in range(2):
        perm = torch.randperm(D.shape[0], generator=torch.Generator().manual_seed(seed)).to(D.device)
        moved = pnp_ista_blocks(Y[:, perm].contiguous(), M[:, perm].contiguous(), D[perm].contiguous(), cfg,
                                alpha=alpha)
        worst = max(worst, float((moved - ref).abs().max()))
    return worst


def _assert_bf16_tracks(got, ref, f32_ref, floor=0.0):
    """The bf16 limits of the module docstring.  On random blocks of many
    rows a flipped rounding shows more often, so the match is 1e-5 max|ref|
    or 4 times ``floor``, the plain loop's own sensitivity to the order of
    its sums on the same problem, whichever is larger."""
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) < max(1e-5 * float(ref.abs().max()), 4.0 * floor)
    assert float((got - f32_ref).abs().max()) < 0.02 * float(f32_ref.abs().max())


def _assert_f32_tracks(got, ref):
    """The f32 limits of the module docstring, and besides max |delta| <
    1e-4 max|ref|: where the outputs are small (at P 1 / K 62908 max|ref|
    is some 3e-6) atol 1e-5 alone would pass any output, zeros included."""
    scale = float(ref.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    assert float((got - ref).abs().max()) < 1e-4 * scale


@pytest.mark.parametrize("nB", [30, 31, 165, 166])
def test_kernel_f32_across_chunk_and_wave_boundaries(cuda, nB):
    """P 48, K 32 in f32 on the resident kernel runs clusters of 8 with up to
    11 rows, 15 at once: 30 rows are 15 chunks of 2 and 31 rows chunks of 3
    with a short last one; 165 rows fill one wave and 166 need a second (the
    plan takes the streamed tier's one wave there, so the resident tiling is
    forced)."""
    plan = _candidate(nB, 48, 32, False, "resident")
    if nB in (165, 166) and plan.resident == 15:
        assert plan.waves == (1 if nB == 165 else 2)
        assert ISTA_KERNEL.plan(nB, 48, 32, False).tier == ("resident" if nB == 165 else "streamed")
    Y, M, D = _problem(cuda, nB, P=48, K=32, seed=nB)
    cfg = SparseProxConfig(n_iter=12)
    with ISTA_KERNEL.forcing(plan):
        got = pnp_ista_blocks_fused(Y, M, D, cfg)
        assert ISTA_KERNEL.last_plan == plan
    torch.testing.assert_close(got, pnp_ista_blocks(Y, M, D, cfg), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("nB", [16, 17, 240, 241])
def test_kernel_bf16_across_chunk_and_wave_boundaries(cuda, nB):
    """The mma tile has 16 rows: 240 rows fill one wave of 15 clusters."""
    Y, M, D = _problem(cuda, nB, P=48, K=32, seed=nB)
    cfg = SparseProxConfig(n_iter=12, matmul_dtype="bfloat16")
    got = pnp_ista_blocks_fused(Y, M, D, cfg)
    ref = pnp_ista_blocks(Y, M, D, cfg)
    f32 = pnp_ista_blocks(Y, M, D, SparseProxConfig(n_iter=12))
    _assert_bf16_tracks(got, ref, f32, floor=_order_sensitivity(Y, M, D, cfg, ref))


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,K", [(50, 32), (1300, 512), (1296, 512), (77, 38)])
def test_kernel_ragged_slices(cuda, P, K, matmul_dtype):
    """P that neither cluster size divides (50 = 7 x 7 + 1, 1300 = 15 x 82 +
    70), the main widths, and a K that is no multiple of 4."""
    Y, M, D = _problem(cuda, 23, P=P, K=K, seed=P)
    cfg = SparseProxConfig(n_iter=8, matmul_dtype=matmul_dtype)
    got = pnp_ista_blocks_fused(Y, M, D, cfg)
    ref = pnp_ista_blocks(Y, M, D, cfg)
    if matmul_dtype == "float32":
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    else:
        f32 = pnp_ista_blocks(Y, M, D, SparseProxConfig(n_iter=8))
        _assert_bf16_tracks(got, ref, f32, floor=_order_sensitivity(Y, M, D, cfg, ref))


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nB,P,K", [(40, 48, 32), (150, 1296, 512)])
def test_two_launches_give_equal_bits(cuda, nB, P, K, matmul_dtype):
    Y, M, D = _problem(cuda, nB, P=P, K=K, seed=5)
    cfg = SparseProxConfig(n_iter=20, matmul_dtype=matmul_dtype)
    first = pnp_ista_blocks_fused(Y, M, D, cfg)
    torch.matmul(Y, D)  # other work in between
    second = pnp_ista_blocks_fused(Y, M, D, cfg)
    assert torch.equal(first, second)


def _main_path_blocks(cuda, n):
    """The first n blocks that the dip solve's first sparse prox gets."""
    from lrs_pnp_dip_tpu_torch.data import load_trained_dictionary, synthetic_sample
    from lrs_pnp_dip_tpu_torch.ops import block_grid, extract_blocks
    from lrs_pnp_dip_tpu_torch.solvers import make_consts
    from lrs_pnp_dip_tpu_torch.utils.config import dip_preset

    cfg = dip_preset()
    consts = make_consts(synthetic_sample(36, 36, 128, seed=0), load_trained_dictionary(512), cfg, device=cuda)
    blocks = extract_blocks(consts.Y, block_grid((36 * 36, 128), cfg.block_size, cfg.stride))
    return blocks[:n].contiguous(), consts.mask_blocks[:n].contiguous(), consts.D


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_kernel_at_the_lrs_pnp_sparse_settings(cuda, matmul_dtype):
    """80 iterations, specnorm alpha and h_scale 0.1, as lrs_pnp_preset, on
    main-path blocks.  With h ten times smaller the NLM's weights are ten
    times as sharp, and the bf16 plain loop itself moves by about 1.2e-5
    max|ref| when only the order of its sums changes
    (``tests/test_torch_ista.py::test_bf16_order_sensitivity``), so the bf16
    match is held to 1e-4 max|ref| here."""
    Y, M, D = _main_path_blocks(cuda, 29)
    sparse = dict(n_iter=80, alpha_mode="specnorm", h_scale=0.1)
    cfg = SparseProxConfig(matmul_dtype=matmul_dtype, **sparse)
    got = pnp_ista_blocks_fused(Y, M, D, cfg)
    ref = pnp_ista_blocks(Y, M, D, cfg)
    if matmul_dtype == "float32":
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    else:
        f32 = pnp_ista_blocks(Y, M, D, SparseProxConfig(**sparse))
        assert torch.isfinite(got).all()
        assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max())
        assert float((got - f32).abs().max()) < 0.02 * float(f32.abs().max())


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [512, 196, 200])
def test_kernel_at_the_auto_dictionary_tiling(cuda, K, matmul_dtype):
    """block_size 24 on the 36x36 cube: nB 324 blocks of P 576, clusters of
    8 in f32 as in bf16; K 512 is the learned dictionary's, K 196 leaves the
    eighth CTA no column and K 200 four, fewer than the NLM's reach."""
    bf16 = matmul_dtype == "bfloat16"
    plan = ISTA_KERNEL.plan(324, 576, K, bf16)
    assert (plan.cluster_size, plan.rows) == (8, 11)
    Y, M, D = _problem(cuda, 324, P=576, K=K, seed=K)
    cfg = SparseProxConfig(n_iter=20, matmul_dtype=matmul_dtype)
    got = pnp_ista_blocks_fused(Y, M, D, cfg)
    ref = pnp_ista_blocks(Y, M, D, cfg)
    if bf16:
        f32 = pnp_ista_blocks(Y, M, D, SparseProxConfig(n_iter=20))
        _assert_bf16_tracks(got, ref, f32, floor=_order_sensitivity(Y, M, D, cfg, ref))
    else:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def test_wrapper_raises_for_shapes_the_kernel_does_not_take(cuda):
    Y, M, D = _problem(cuda, 4, P=2916, K=512)  # block 54: past the TPU kernel's range
    with pytest.raises(ValueError, match="past the TPU kernel's range"):
        pnp_ista_blocks_fused(Y, M, D, SparseProxConfig(n_iter=2))
    before = ISTA_KERNEL.launches
    Y, M, D = _problem(cuda, 4, P=48, K=5)
    with pytest.raises(ValueError, match="K >= 6"):
        pnp_ista_blocks_fused(Y, M, D, SparseProxConfig(n_iter=2))
    assert ISTA_KERNEL.launches == before


def test_lockstep_engine_launches_once_per_outer_step(cuda):
    """Three `lrs_pnp` lanes on the card: one launch of B1 per outer step
    over the 3 x 72 blocks, every lane within 1e-4 of the single solve on
    the card and of the engine on the CPU."""
    rng = np.random.default_rng(0)
    D = rng.standard_normal((36, 48)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    cfg = SolverConfig(
        variant="lrs_pnp", outer_iters=2, block_size=6, stride=6, dip=None, mu1=0.15, mu2=0.9,
        sparse=SparseProxConfig(n_iter=10, alpha_mode="specnorm", h_scale=0.1),
    )
    samples = [synthetic_sample(12, 12, 16, missing=0.1, seed=k) for k in (3, 4, 5)]
    engine = BatchedSolver(samples, D, cfg, device=cuda)
    ISTA_KERNEL.launches = 0
    state, hist = engine.run()
    assert ISTA_KERNEL.launches == 2 and ISTA_KERNEL.last_plan.nB == 3 * 72
    cpu_state, cpu_hist = BatchedSolver(samples, D, cfg, device="cpu").run()
    scale = float(cpu_state.X.abs().max())
    assert float((state.X.cpu() - cpu_state.X).abs().max()) < 1e-4 * scale
    np.testing.assert_allclose(hist["mpsnr"], cpu_hist["mpsnr"], atol=1e-3)
    for i, s in enumerate(samples):
        one, _ = Solver(s, D, cfg, device=cuda).run()
        assert float((state.X[i] - one.X).abs().max()) < 1e-4 * scale


def test_svt_gram_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(1)
    X = (rng.standard_normal((3, 200, 4)) @ rng.standard_normal((3, 4, 16))).astype(np.float32)
    X += 0.05 * rng.standard_normal(X.shape).astype(np.float32)
    got = svt_gram(torch.from_numpy(X).to(cuda), 1 / 0.9).cpu()
    ref = svt_gram(torch.from_numpy(X), 1 / 0.9)
    assert float((got - ref).abs().max()) < 2e-5 * float(np.abs(X).max())


@pytest.mark.parametrize(
    "nB,P,K,matmul_dtype",
    [(40, 48, 32, "float32"), (13, 48, 32, "float32"), (144, 576, 1152, "float32"), (144, 576, 1152, "bfloat16")],
    ids=["40", "13", "P576-K1152-f32", "P576-K1152-bf16"],
)
def test_sharded_prox_launches_once_per_rank_with_equal_bits(cuda, nB, P, K, matmul_dtype):
    """Two ranks on the one card over gloo ({patch: 2}): each launches B1
    once on its half of the rows (13 takes one padding row), and the
    gathered rows equal one launch over all rows bit for bit.  At P 576 / K
    1152 the plan puts 144 rows on the column tier's clusters of 8 and 72
    rows alone on its clusters of 16 (f32) or the streamed tier (bf16): each
    rank launches its share of the whole's tiling (``shares_of``)."""
    from lrs_pnp_dip_tpu_torch.ops import sparse_prox
    from lrs_pnp_dip_tpu_torch.parallel.launch import spawn
    from lrs_pnp_dip_tpu_torch.parallel.workers import run_cases

    ISTA_KERNEL.build()  # once, before the ranks load the library
    Y, M, D = _problem(cuda, nB, P=P, K=K, seed=nB)
    cfg = SparseProxConfig(n_iter=15, matmul_dtype=matmul_dtype)
    if P == 576:
        bf16 = matmul_dtype == "bfloat16"
        whole, alone = ISTA_KERNEL.plan(nB, P, K, bf16), ISTA_KERNEL.plan(nB // 2, P, K, bf16)
        assert whole.tier == "column" and (alone.tier, alone.cluster_size) != ("column", whole.cluster_size)
    case = dict(axis_sizes={"patch": 2}, blocks=Y.cpu().numpy(), mask=M.cpu().numpy(), D=D.cpu().numpy(), cfg=cfg)
    ranks = spawn(run_cases, 2, args=("cuda", [("prox_case", case)]), device="cuda")
    ref = sparse_prox(Y, M, D, cfg).cpu().numpy()
    for (got,) in ranks:
        assert (got["launches"], got["nB"]) == (1, -(-nB // 2))
        np.testing.assert_array_equal(got["out"], ref)


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_b1_replayed_from_a_graph_gives_the_eager_bits(cuda, matmul_dtype):
    """Kernel B1 at the main shape (nB 144, P 1296, K 512) captured in a CUDA
    graph: each replay equals an eager launch bit for bit, the capture
    counts no launch, and each replay counts the one it holds."""
    from lrs_pnp_dip_tpu_torch.solvers.graphs import Captured

    Y, M, D = _problem(cuda, 144, P=1296, K=512, seed=7)
    cfg = SparseProxConfig(n_iter=100, matmul_dtype=matmul_dtype)
    eager = pnp_ista_blocks_fused(Y, M, D, cfg)
    graph = Captured(lambda: pnp_ista_blocks_fused(Y, M, D, cfg), cuda)
    ISTA_KERNEL.launches = 0
    warm = graph()  # the first call runs eagerly
    assert graph.graph is None and ISTA_KERNEL.launches == 1
    first = graph()  # the second captures, then replays
    assert graph.b1_launches == 1 and ISTA_KERNEL.launches == 2
    pnp_ista_blocks_fused(Y[:13], M[:13], D, cfg)  # another launch between two replays
    second = graph()
    torch.cuda.synchronize()
    assert ISTA_KERNEL.launches == 4 and ISTA_KERNEL.last_plan.nB == 144  # the replay's tiling
    for got in (warm, first, second):
        assert torch.equal(got, eager)


def test_a_capture_that_fails_raises(cuda):
    """``torch.linalg.eigh`` reads cuSOLVER's status on the host, which a
    capture refuses: the second call of a Captured that runs it raises,
    and nothing is run eagerly in its place.  In a fresh process: a failed
    capture can leave the process's CUDA context unusable."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from lrs_pnp_dip_tpu_torch.solvers.graphs import Captured\n"
        "G = torch.eye(8, device='cuda')\n"
        "graph = Captured(lambda: torch.linalg.eigh(G), 'cuda')\n"
        "graph()\n"
        "try:\n"
        "    graph()\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__, graph.graph is None)\n"
        "else:\n"
        "    print('did not raise')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert "raised" in proc.stdout and "True" in proc.stdout, proc.stdout + proc.stderr


def test_run_scanned_on_the_card_equals_run(cuda):
    """Solver.run_scanned replays graphs A and B around the eager eigh (and
    B1 inside A): the same kernels as run, so the same bits, and one
    launch of B1 per outer step."""
    rng = np.random.default_rng(0)
    D = rng.standard_normal((36, 48)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    sample = synthetic_sample(12, 12, 16, missing=0.1, seed=3)
    cfg = SolverConfig(variant="lrs_pnp", block_size=6, stride=6, sparse=SparseProxConfig(n_iter=20))
    solver = Solver(sample, D, cfg, device=cuda)
    ref, ref_hist = solver.run(4)
    ISTA_KERNEL.launches = 0
    got, hist = solver.run_scanned(4)
    again, _ = solver.run_scanned(4)
    assert ISTA_KERNEL.launches == 8
    assert torch.equal(got.X, ref.X) and torch.equal(again.X, ref.X)
    np.testing.assert_array_equal(hist["mpsnr"], np.float32(ref_hist["mpsnr"]))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_dip_fit_replayed_equals_the_host_stepped_fit(cuda, compute_dtype):
    """The DIP iteration replayed from a graph in chunks gives the
    host-stepped fit's bits, its iteration count and its stop, with the
    presets' reflection padding and the caller's cuDNN flags as they are:
    every fit runs with a fixed-order padding backward and cuDNN's
    deterministic algorithms, so two host-stepped fits agree too."""
    from lrs_pnp_dip_tpu_torch.models import Skip
    from lrs_pnp_dip_tpu_torch.solvers import DipFit
    from lrs_pnp_dip_tpu_torch.utils.config import DipConfig

    rng = np.random.default_rng(5)
    x, t = (torch.from_numpy(rng.random((1, 12, 12, 8), dtype=np.float32)).to(cuda) for _ in range(2))
    m = torch.from_numpy((rng.random((1, 12, 12, 1)) > 0.15).astype(np.float32)).to(cuda)
    net = Skip(num_input_channels=8, num_output_channels=8, channels_down=(8, 8), channels_up=(8, 8),
               channels_skip=(4, 4), pad="reflection").to(cuda)
    fit = DipFit(net, DipConfig(num_iter=40, buffer_size=3, patience=2, learning_rate=0.01,
                                compute_dtype=compute_dtype))
    gen = torch.Generator(device=cuda)
    host = fit(x, t, m, generator=gen.manual_seed(0))
    assert torch.equal(fit(x, t, m, generator=gen.manual_seed(0)).out, host.out)
    for chunk in (1, 3, 8):
        got = fit(x, t, m, generator=gen.manual_seed(0), chunk=chunk)
        assert (got.n_iters, got.stopped) == (host.n_iters, host.stopped)
        assert torch.equal(got.out, host.out) and torch.equal(got.loss, host.loss)
    assert not torch.backends.cudnn.deterministic  # the caller's flag, given back


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_solver_run_replays_the_fit(cuda, compute_dtype):
    """``Solver.run`` of `dip` replays each step's DIP fit (one read of the
    stop flag per FIT_CHUNK iterations) and gives the bits and dip_iters of
    the same 2 steps with host-stepped fits, one launch of B1 per step; in
    bf16 with bf16 sparse-prox operands, as `dip_fast`."""
    from lrs_pnp_dip_tpu_torch.models import Skip
    from lrs_pnp_dip_tpu_torch.solvers import FIT_CHUNK
    from lrs_pnp_dip_tpu_torch.utils.config import DipConfig

    rng = np.random.default_rng(0)
    D = rng.standard_normal((36, 48)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    sample = synthetic_sample(12, 12, 16, missing=0.1, seed=3)
    cfg = SolverConfig(
        block_size=6, stride=6, sparse=SparseProxConfig(n_iter=20, matmul_dtype=compute_dtype),
        dip=DipConfig(num_iter=40, buffer_size=3, patience=2, learning_rate=0.01, compute_dtype=compute_dtype),
    )
    runs = {}
    for mode in ("replayed", "host"):
        net = Skip(num_input_channels=16, num_output_channels=16, channels_down=(8, 8), channels_up=(8, 8),
                   channels_skip=(4, 4), pad="reflection")
        solver = Solver(sample, D, cfg, net=net, device=cuda)
        if mode == "host":
            solver.stages.fit_chunk = None
        reads = []
        ISTA_KERNEL.launches = 0
        state, hist = solver.run(2, callback=lambda i, st, aux: reads.append(solver.stages.dip_fit.flag_reads))
        torch.cuda.synchronize()
        assert ISTA_KERNEL.launches == 2
        iters = [int(n) for n in hist["dip_iters"]]
        assert reads == (iters if mode == "host" else [-(-n // FIT_CHUNK) for n in iters])
        runs[mode] = state, iters
    assert runs["replayed"][1] == runs["host"][1]
    for name in ("X", "lambda1", "lambda2"):
        assert torch.equal(getattr(runs["replayed"][0], name), getattr(runs["host"][0], name)), name


@pytest.mark.parametrize("settings", ["dip", "lrs_pnp"])
def test_resident_bf16_kernel_at_its_widest_K(cuda, settings):
    """The resident bf16 kernel sums product 1 over all K in each warp's
    mma chain: 40 k steps at K 640 (its widest), where the column kernel
    needed its chains cut.  Main-path blocks against a random 1296x640
    unit-column dictionary, nB 144, at the `dip` sparse settings (100
    iterations, trace4 alpha, h_scale 1) and the `lrs_pnp` ones (80,
    specnorm, 0.1), held to the larger of the plain loop's two floors (rows
    of D permuted, products on the tensor cores)."""
    Y, M, _ = _main_path_blocks(cuda, 144)
    rng = np.random.default_rng(640)
    D = rng.standard_normal((1296, 640)).astype(np.float32)
    D = torch.from_numpy(D / np.linalg.norm(D, axis=0, keepdims=True)).to(cuda)
    sparse = (dict(n_iter=100, alpha_mode="trace4", h_scale=1.0) if settings == "dip"
              else dict(n_iter=80, alpha_mode="specnorm", h_scale=0.1))
    cfg = SparseProxConfig(matmul_dtype="bfloat16", **sparse)
    plan = ISTA_KERNEL.plan(144, 1296, 640, True)
    assert (plan.tier, plan.K) == ("resident", 640)
    alpha = compute_alpha(D, M, cfg)
    got = pnp_ista_blocks_fused(Y, M, D, cfg, alpha=alpha)
    torch.cuda.synchronize()
    assert ISTA_KERNEL.last_plan.tier == "resident"
    ref = pnp_ista_blocks(Y, M, D, cfg, alpha=alpha)
    floor = max(_order_sensitivity(Y, M, D, cfg, ref, alpha), _tensor_core_sensitivity(Y, M, D, cfg, ref, alpha))
    f32_ref = pnp_ista_blocks(Y, M, D, SparseProxConfig(**sparse), alpha=alpha)
    _assert_bf16_tracks(got, ref, f32_ref, floor)


@pytest.mark.parametrize(
    "nB,P,K,matmul_dtype,tier,pick",
    [(13, 1700, 40, "float32", "streamed", "column"), (9, 1700, 30, "float32", "streamed", "column"),
     (20, 2704, 64, "float32", "streamed", "column"), (3, 16, 6000, "float32", "column", "column"),
     (5, 200, 700, "bfloat16", "streamed", "streamed"), (3, 16, 3000, "bfloat16", "column", "column"),
     (17, 576, 1152, "bfloat16", "streamed", "streamed"), (21, 2704, 512, "float32", "streamed", "column"),
     (7, 1296, 1000, "float32", "streamed", "column"), (9, 1296, 1030, "bfloat16", "streamed", "streamed"),
     (4, 1024, 1200, "float32", "column", "column"), (3, 7, 196, "bfloat16", "streamed", "resident"),
     (240, 2704, 64, "float32", "streamed", "streamed"), (240, 1296, 1000, "float32", "streamed", "streamed"),
     (5, 1296, 1022, "float32", "streamed", "column")],
    ids=["f32-slices-past-96", "f32-K-not-multiple-of-4", "f32-block-52", "f32-K-6000",
         "bf16-K-past-640", "bf16-K-3000", "bf16-P576-K1152", "f32-block-52-K512",
         "f32-K1000-nothing-resident", "bf16-K1030-partly-resident", "f32-K1200", "bf16-K196-forced",
         "f32-16-rows-stages-of-16", "f32-16-rows-stages-of-8", "f32-K1022-rows-copied"],
)
def test_streamed_kernel_matches_plain(cuda, nB, P, K, matmul_dtype, tier, pick):
    """Shapes the resident kernel does not take run on the streamed kernel,
    or past its columns on the column kernel: against the plain loop
    at the limits of the module docstring (bf16: or 4 times the plain loop's
    own order sensitivity; f32 also within 1e-4 of max|ref|), two launches
    equal.  Where the plan picks another tier (``pick``: the column tier,
    predicted faster, at most of the f32 shapes; the resident kernel at K
    196) the tiling of ``tier`` is forced (at K 196, P 7: the last CTA owns no
    row of D and no column of x); the cases at nB 240 run tiles of 16 block
    rows; K 1022 streams rows copied from D with their padding."""
    Y, M, D = _problem(cuda, nB, P=P, K=K, seed=P + K)
    cfg = SparseProxConfig(n_iter=12, matmul_dtype=matmul_dtype)
    bf16 = matmul_dtype == "bfloat16"
    assert ISTA_KERNEL.plan(nB, P, K, bf16).tier == pick
    plan = _candidate(nB, P, K, bf16, tier)
    if K == 196:
        assert plan.p_slices()[-1][0] == P
    with ISTA_KERNEL.forcing(plan):
        got = pnp_ista_blocks_fused(Y, M, D, cfg)
        again = pnp_ista_blocks_fused(Y, M, D, cfg)
        torch.cuda.synchronize()
        assert ISTA_KERNEL.last_plan == plan and torch.equal(got, again)
    ref = pnp_ista_blocks(Y, M, D, cfg)
    if matmul_dtype == "float32":
        _assert_f32_tracks(got, ref)
    else:
        f32_ref = pnp_ista_blocks(Y, M, D, SparseProxConfig(n_iter=12))
        _assert_bf16_tracks(got, ref, f32_ref, _order_sensitivity(Y, M, D, cfg, ref))
    assert torch.all(got[1] == 0.0)


# The shapes at which the plan chooses between B1's tiers (chip_smoke.TIER_SHAPES).
TIER_SHAPES = [
    (nB, P, K, mm)
    for nB, P, K, types in (
        (144, 1296, 512, "fb"), (72, 1296, 512, "fb"), (288, 1296, 512, "fb"), (576, 1296, 512, "fb"),
        (2304, 1296, 512, "fb"), (324, 576, 512, "fb"), (1296, 576, 512, "fb"), (132, 1600, 512, "fb"),
        (144, 2304, 512, "fb"), (144, 2704, 512, "fb"), (144, 1296, 1024, "fb"), (144, 576, 1152, "fb"),
        (144, 1296, 1152, "b"),
    )
    for mm in (("float32",) if "f" in types else ()) + (("bfloat16",) if "b" in types else ())
]


# Every candidate at 12 iterations too, at nB 72 (one rank's share of the main
# shape under {patch: 2}).  In bf16 the column tier misses there: its output
# leaves the plain loop's in one jump at iteration 6 in one row, by 1.57e-5
# of max|ref| (one flipped bf16 rounding), where none of 32 orders of the
# plain loop's sums flips a rounding that far (PERF.md section 6;
# scripts/witness_b1_bf16.py).  The plan never picks that tier at this
# shape; the failure stands until the column kernel's sums flip no more
# often than the plain loop's (ROADMAP.md, C9).
CANDIDATE_CASES = [shape + (100,) for shape in TIER_SHAPES] + [
    (72, 1296, 512, "float32", 12), (72, 1296, 512, "bfloat16", 12)]


@pytest.mark.parametrize("nB,P,K,matmul_dtype,n_iter", CANDIDATE_CASES,
                         ids=["nB{}-P{}-K{}-{}{}".format(nB, P, K, mm[:4], "" if n == 100 else f"-{n}it")
                              for nB, P, K, mm, n in CANDIDATE_CASES])
def test_every_candidate_tier_matches_plain(cuda, nB, P, K, matmul_dtype, n_iter):
    """Every tiling of plan_candidates at each shape of the plan's sweep,
    forced in turn, on random blocks, 100 iterations (the sweep's and the
    paths'; 12 at nB 72): two launches give equal bits, the second after
    other work; against the plain loop, f32 at the limits of
    _assert_f32_tracks, bf16 within 0.02 of the f32 plain loop and within
    1e-5 max|ref| or 4 times the larger of the bf16 plain loop's two floors
    (rows of D permuted, products on the tensor cores); a fully missing
    block stays 0.  The plan's own pick is one of them.  Every tier is
    checked, and the failure names each tier that missed."""
    bf16 = matmul_dtype == "bfloat16"
    Y, M, D = _problem(cuda, nB, P=P, K=K, seed=P + K)
    cfg = SparseProxConfig(n_iter=n_iter, matmul_dtype=matmul_dtype)
    alpha = compute_alpha(D, M, cfg)
    ref = pnp_ista_blocks(Y, M, D, cfg, alpha=alpha)
    if bf16:
        floor = max(_order_sensitivity(Y, M, D, cfg, ref, alpha), _tensor_core_sensitivity(Y, M, D, cfg, ref, alpha))
        f32_ref = pnp_ista_blocks(Y, M, D, SparseProxConfig(n_iter=n_iter), alpha=alpha)
    plans = plan_candidates(nB, P, K, bf16, ISTA_KERNEL.resident_clusters(bf16), _MAX_SMEM_BYTES)
    assert len(plans) >= 2 and ISTA_KERNEL.plan(nB, P, K, bf16) in plans
    missed = []
    for plan in plans:
        with ISTA_KERNEL.forcing(plan):
            got = pnp_ista_blocks_fused(Y, M, D, cfg, alpha=alpha)
            torch.matmul(Y, D)  # other work in between
            again = pnp_ista_blocks_fused(Y, M, D, cfg, alpha=alpha)
            torch.cuda.synchronize()
            assert ISTA_KERNEL.last_plan == plan
        try:
            assert torch.equal(got, again)
            if bf16:
                _assert_bf16_tracks(got, ref, f32_ref, floor)
            else:
                _assert_f32_tracks(got, ref)
            assert torch.all(got[1] == 0.0)
        except AssertionError as e:
            err = float((got - ref).abs().max())
            missed.append(f"tier {plan.tier} (C{plan.cluster_size} R{plan.rows}): max|delta| {err:.3e} = "
                          f"{err / float(ref.abs().max()):.3e} of max|ref|: {e}")
    assert not missed, "; ".join(missed)


def _zero_padded_slices(Y, M, D, plan, rows):
    """The problem with each CTA's slice of D (``plan.p_slices()``) padded
    with zero rows of D, Y and M to ``rows`` rows: the same sums, each
    streamed stage whole."""
    C = plan.cluster_size
    Yp, Mp = (torch.zeros((t.shape[0], C * rows), device=t.device) for t in (Y, M))
    Dp = torch.zeros((C * rows, D.shape[1]), device=D.device)
    for c, (pa, pb) in enumerate(plan.p_slices()):
        Yp[:, c * rows:c * rows + pb - pa] = Y[:, pa:pb]
        Mp[:, c * rows:c * rows + pb - pa] = M[:, pa:pb]
        Dp[c * rows:c * rows + pb - pa] = D[pa:pb]
    return Yp, Mp, Dp


def _tensor_core_sensitivity(Y, M, D, cfg, ref, alpha=None):
    """max |delta| of the bf16 plain loop against itself with its products
    on the tensor cores (TF32 takes the bf16-valued operands exactly and
    accumulates in f32 as the kernel's mma.sync does), in cuBLAS's order."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        moved = pnp_ista_blocks(Y, M, D, cfg, alpha=alpha)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return float((moved - ref).abs().max())


@pytest.mark.parametrize(
    "P,K,matmul_dtype",
    [(400, 1024, "bfloat16"), (529, 1024, "bfloat16"), (1296, 1004, "float32")],
    ids=["bf16-one-short-stage", "bf16-short-second-stage", "f32-K1004-columns-past-K"],
)
def test_streamed_kernel_short_stage_in_a_fresh_slot(cuda, P, K, matmul_dtype):
    """At nB 144 and K 1024 in bf16 (10 rows per cluster, 48 of each slice
    resident) P 400 streams one stage of 2 rows per CTA and P 529 two, the
    second of 3 rows: each short stage is the first of its pass in its slot,
    whose other rows held the partial gradient in the step 3 before (read as
    bf16, such bits were Inf or NaN).  At K 1004 in f32 the bulk copies
    write 1004 of each row's 1008 columns.  12 iterations, two launches
    equal; equal bits to the same problem with each slice padded by zero
    rows to whole stages (the same sums); against the plain loop, f32 at the
    limits of the module docstring, bf16 finite, within 0.02 of the f32
    plain loop and within 1e-5 max|ref| or 4 times the bf16 plain loop's own
    movement, whichever is larger: with the rows of D permuted
    (_order_sensitivity) or with its products on the tensor cores.  At P 400
    max|ref| is 0.015, and one residual whose bf16 rounding flips moves an
    output by about 1e-5 of it; the f32 kernel must still fail the limit.
    The plan picks the column tier at these shapes (predicted faster), so
    the streamed tilings are forced."""
    nB = 144
    bf16 = matmul_dtype == "bfloat16"
    assert ISTA_KERNEL.plan(nB, P, K, bf16).tier == "column"
    plan = _candidate(nB, P, K, bf16, "streamed")
    assert (plan.tier, plan.cluster_size, plan.rows) == ("streamed", 8, 10) and plan.stages > 0
    Y, M, D = _problem(cuda, nB, P=P, K=K, seed=P + K)
    cfg = SparseProxConfig(n_iter=12, matmul_dtype=matmul_dtype)
    alpha = compute_alpha(D, M, cfg)  # one alpha for both layouts: its sum over P runs in cuBLAS's order
    rows = plan.resident_rows + -(-plan.streamed_rows // plan.stage_rows) * plan.stage_rows
    padded = _zero_padded_slices(Y, M, D, plan, rows)
    whole = _candidate(nB, plan.cluster_size * rows, K, bf16, "streamed")
    assert (whole.cluster_size, whole.rows, whole.resident_rows, whole.stage_rows, whole.stages) == (
        plan.cluster_size, plan.rows, plan.resident_rows, plan.stage_rows, plan.stages)
    assert whole.streamed_rows % whole.stage_rows == 0
    with ISTA_KERNEL.forcing(plan, whole):
        got = pnp_ista_blocks_fused(Y, M, D, cfg, alpha=alpha)
        again = pnp_ista_blocks_fused(Y, M, D, cfg, alpha=alpha)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and torch.equal(got, again)
        assert torch.equal(pnp_ista_blocks_fused(*padded, cfg, alpha=alpha), got)
    ref = pnp_ista_blocks(Y, M, D, cfg, alpha=alpha)
    assert torch.all(got[1] == 0.0)
    if not bf16:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
        return
    floor = max(_order_sensitivity(Y, M, D, cfg, ref, alpha), _tensor_core_sensitivity(Y, M, D, cfg, ref, alpha))
    f32_ref = pnp_ista_blocks(Y, M, D, SparseProxConfig(n_iter=12), alpha=alpha)
    _assert_bf16_tracks(got, ref, f32_ref, floor)
    with ISTA_KERNEL.forcing(plan):
        f32_out = pnp_ista_blocks_fused(Y, M, D, SparseProxConfig(n_iter=12), alpha=alpha)
    f32_gap = float((f32_out - ref).abs().max())
    assert f32_gap >= max(1e-5 * float(ref.abs().max()), 4.0 * floor)


@pytest.mark.parametrize(
    "nB,P,K,matmul_dtype",
    [(144, 1296, 1152, "float32"), (144, 576, 2048, "float32"), (144, 576, 2048, "bfloat16"),
     (144, 1000, 1300, "bfloat16"), (144, 1296, 1030, "float32"), (144, 1, 62908, "float32"),
     (144, 16, 39308, "bfloat16"), (40, 1296, 1152, "float32")],
    ids=["f32-P1296-K1152", "f32-P576-K2048", "bf16-P576-K2048", "bf16-short-last-tile", "f32-K1030-rows-copied",
         "f32-longest-K-at-P1", "bf16-longest-K-at-P16", "f32-six-rows-on-the-12-row-tile"],
)
def test_column_kernel_matches_plain(cuda, nB, P, K, matmul_dtype):
    """The column tier, 12 iterations, at nB 144: P 1296 / K 1152 (the
    reference block past the streamed kernel's columns) and P 576 / K 2048
    with rows of D[:, k_c] read from L2 in both products; P 1000 in bf16,
    whose last 16-row tile of D reaches past P (its loads masked to zeros,
    the residual's padding columns zero) and whose last CTA owns a short
    segment of columns; K 1030 in f32, whose rows the launch copies padded
    to 16 bytes; and the longest K of the range, at P 1 in f32 and at P 16
    in bf16 (nothing resident).  At nB 40, P 1296 / K 1152 runs 6 rows per
    cluster on the f32 tile of 12 rows.  Two launches give equal bits; f32
    at the limits of the module docstring and within 1e-4 of max|ref|; bf16
    finite, within 0.02 of the f32 plain loop and within 1e-5 max|ref| or 4
    times the bf16 plain loop's own movement (rows of D permuted, or its
    products on the tensor cores), which the f32 kernel fails."""
    bf16 = matmul_dtype == "bfloat16"
    plan = ISTA_KERNEL.plan(nB, P, K, bf16)
    assert plan.tier == "column" and plan.n_clusters * plan.rows >= nB
    if nB == 40:
        assert 4 < plan.rows <= 8
    if P == 1000:
        assert P % 16 and plan.resident_rows < P and plan.k_segments()[-1][1] - plan.k_segments()[-1][0] < plan.seg
    Y, M, D = _problem(cuda, nB, P=P, K=K, seed=P + K)
    cfg = SparseProxConfig(n_iter=12, matmul_dtype=matmul_dtype)
    alpha = compute_alpha(D, M, cfg)
    got = pnp_ista_blocks_fused(Y, M, D, cfg, alpha=alpha)
    again = pnp_ista_blocks_fused(Y, M, D, cfg, alpha=alpha)
    torch.cuda.synchronize()
    assert ISTA_KERNEL.last_plan.tier == "column"
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert torch.all(got[1] == 0.0)
    ref = pnp_ista_blocks(Y, M, D, cfg, alpha=alpha)
    if not bf16:
        _assert_f32_tracks(got, ref)
        return
    floor = max(_order_sensitivity(Y, M, D, cfg, ref, alpha), _tensor_core_sensitivity(Y, M, D, cfg, ref, alpha))
    f32_ref = pnp_ista_blocks(Y, M, D, SparseProxConfig(n_iter=12), alpha=alpha)
    _assert_bf16_tracks(got, ref, f32_ref, floor)
    f32_gap = float((pnp_ista_blocks_fused(Y, M, D, SparseProxConfig(n_iter=12), alpha=alpha) - ref).abs().max())
    assert f32_gap >= max(1e-5 * float(ref.abs().max()), 4.0 * floor)


def test_streamed_kernel_replayed_from_a_graph(cuda):
    """Each streaming tier replayed from a graph gives its eager bits (at P
    1700 / K 40 in f32 the plan picks the column tier; the streamed tiling
    is forced); so do the shapes whose tier the plan's timings moved, P 576 /
    K 1152 (f32 off the resident tier, bf16 off the streamed one) and P 1296
    / K 1024 in f32 (off the streamed tier), now on the column tier."""
    from lrs_pnp_dip_tpu_torch.solvers.graphs import Captured

    for nB, P, K, mm, tier in ((13, 1700, 40, "float32", "streamed"), (9, 1296, 1030, "bfloat16", "streamed"),
                               (3, 16, 3000, "bfloat16", "column"), (144, 1296, 1152, "float32", "column"),
                               (144, 576, 2048, "bfloat16", "column"), (144, 576, 1152, "float32", "column"),
                               (144, 576, 1152, "bfloat16", "column"), (144, 1296, 1024, "float32", "column")):
        Y, M, D = _problem(cuda, nB, P=P, K=K)
        cfg = SparseProxConfig(n_iter=12, matmul_dtype=mm)
        with ISTA_KERNEL.forcing(_candidate(nB, P, K, mm == "bfloat16", tier)):
            eager = pnp_ista_blocks_fused(Y, M, D, cfg)
            graph = Captured(lambda: pnp_ista_blocks_fused(Y, M, D, cfg), cuda)
            graph()
            assert torch.equal(graph(), eager) and torch.equal(graph(), eager)
        assert graph.b1_launches == 1 and graph.b1_plan.tier == tier


def test_captures_run_under_deterministic_cudnn(cuda):
    from lrs_pnp_dip_tpu_torch.solvers.graphs import Captured

    seen = []
    x = torch.ones(4, device=cuda)

    def fn():
        seen.append((torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark))
        return x * 2

    graph = Captured(fn, cuda)
    graph()
    graph()
    assert seen == [(True, False)] * 2
    assert not torch.backends.cudnn.deterministic


def test_bm3d_repeats_on_the_card(cuda):
    from lrs_pnp_dip_tpu_torch.ops import bm3d_prox

    cube = torch.from_numpy(np.random.default_rng(2).random((20, 18, 3), dtype=np.float32)).to(cuda)
    first = bm3d_prox(cube, 0.1)
    assert torch.equal(bm3d_prox(cube, 0.1), first) and torch.isfinite(first).all()


@pytest.mark.parametrize("net_key", ["skip", "lipschitz_unet", "ResNet"])
def test_two_dip_fits_of_the_zoo_nets_repeat(cuda, net_key):
    """Two eager fits and two graphed fits of a reflection-padded net from
    one init give equal bits, and graphed equals eager."""
    from lrs_pnp_dip_tpu_torch.models import get_net
    from lrs_pnp_dip_tpu_torch.solvers import DipFit
    from lrs_pnp_dip_tpu_torch.utils.config import DipConfig

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((1, 36, 36, 8), dtype=np.float32)).to(cuda)
    net = get_net(8, net_key, pad="reflection", n_channels=8).to(cuda)
    fit = DipFit(net, DipConfig(num_iter=12, patience=10**9, learning_rate=0.01))
    gen = torch.Generator(device=cuda)
    outs = [fit(x, x, torch.ones_like(x), generator=gen.manual_seed(0), chunk=c).out for c in (None, None, 4, 4)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
