"""The port's Lipschitz U-Net (`dip_1lip`) against the benchmark's plain
reference, ``portbench/reference/lipschitz_unet.py``, and the benchmark's
1-Lip cell on the CPU: its traffic driver end to end, sound and with the
spectral norm left out, and its two trace readers on hand-made traces.

Tolerances, each as a share of the reference's largest entry:

* one forward, 1e-5 (measured 8.7e-7 at width 16 and 2.3e-6 at width 128):
  the same operations in another order of f32 summation (the port pads and
  convolves through its own padding function, the reference by ``cat``);
  the advanced vectors u are the same operations on the same operands, and
  are held to 1e-6 (measured equal bits);
* a fit of 3 iterations, 5e-4 (measured at most 5.1e-5 over five draws) at
  lr 1e-5, while the output moves 5 to 10% over those iterations: Adam's
  first steps move each weight by about lr times the sign of its gradient,
  and the gradients of the conv biases in front of a batch norm are zero up
  to rounding, with other signs on the two sides (measured: 5 to 12 of 16 a
  layer).  At lr 1e-4 a draw parted by 1.4e-3 at the third iteration, and at
  the preset's lr 0.1 by 2 to 13%: at that rate two sound fits part at the
  first step;
* one outer step, the same 5e-4 for the DIP output and the state.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import program  # noqa: E402
import run  # noqa: E402
from reference import lipschitz_unet as lip  # noqa: E402
from reference import solver as ref  # noqa: E402
from traffic.base import Record  # noqa: E402
from yardstick import inputs  # noqa: E402
from yardstick.trace import Interval, Trace  # noqa: E402

from lrs_pnp_dip_tpu_torch.models import LipschitzUNet  # noqa: E402
from lrs_pnp_dip_tpu_torch.solvers.dip import FIT_CHUNK, make_dip_fit  # noqa: E402
from lrs_pnp_dip_tpu_torch.utils.config import DipConfig  # noqa: E402

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

FORWARD_TOL = 1e-5
FIT_TOL = 5e-4


def _gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _params(bands, width, seed):
    return lip.init_params(lip.param_spec(bands, width), torch.Generator().manual_seed(seed), "cpu")


def _setup(**kw):
    base = dict(variant="dip_1lip", gamma=0.5, mu1=0.1, mu2=0.1, block_size=36, stride=36, lambda_ista=0.1,
                n_iter=4, alpha_mode="trace4", h_scale=1.0, power_iters=50, dip_num_iter=3, dip_lr=1e-5,
                dip_window=30, dip_patience=60)
    base.update(kw)
    return ref.Setup(**base)


@pytest.mark.parametrize("width, bands", [(16, 8), (128, 128)], ids=["w16", "published"])
def test_forward_and_advanced_u_match_the_reference(width, bands):
    p = _params(bands, width, 0)
    net = LipschitzUNet(bands, num_output_channels=bands, width=width)
    assert set(net.state_dict()) == set(p)
    net.load_state_dict(p)
    x = torch.rand((1, 36, 36, bands), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = net(x).permute(0, 3, 1, 2)
    state = dict(p)
    want = lip.forward(state, x.permute(0, 3, 1, 2))
    assert _gap(got, want) < FORWARD_TOL
    advanced = 0
    for name, u in net.state_dict().items():
        if name.endswith(".u"):
            torch.testing.assert_close(u, state[name], rtol=1e-6, atol=1e-7)
            advanced += not torch.equal(u, p[name])
    assert advanced == lip.N_CONVS


def test_counts_follow_the_published_net():
    """238 products a forward (the port's counter and the reference's
    count), the spatial sizes of the configuration file, and the operation
    count built from the convolutions' shapes."""
    config = json.loads((BENCH / "configs" / "dip_1lip.json").read_text())
    net = LipschitzUNet(128, num_output_channels=128, width=128)
    assert net.power_products == len(lip.conv_shapes(128)) * (2 * lip.POWER_ITERS + 1) == 238
    assert config["net"]["power_products_per_forward"] == 238
    assert LipschitzUNet(8, num_output_channels=8, width=8, sn_mode="exact").power_products == 0
    layers = lip.conv_layers(36, 36, 128)
    assert [ho for _, _, _, _, ho, _, _ in layers] == [18, 18, 9, 9, 5, 5, 3, 3, 5, 9, 18, 36, 36, 36]
    spec = [(c["kernel"], c["stride"], c["padding"]) for c in config["net"]["convs"]]
    assert spec == [(k, s, (k - 1) // 2) for _, _, _, k, s in lip.conv_shapes(128)]
    convs = sum(2 * ci * co * k * k * ho * wo * (3 if grad else 2) for _, ci, co, k, ho, wo, grad in layers)
    assert lip.fit_flops_per_iteration(36, 36, 128) == convs + 17 * sum(2 * co * ci * k * k for _, ci, co, k, *_ in layers)
    assert program.solver_config(config["solver"]) == program.preset("dip_1lip", outer_iters=10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_iteration_fit_matches_the_reference(seed):
    noisy, mask, _ = inputs.synthetic_sample(36, 36, 8, seed=3)
    p = _params(8, 16, seed)
    z = torch.rand((1, 36, 36, 8), generator=torch.Generator().manual_seed(10 + seed))
    y, m = torch.as_tensor(noisy)[None], torch.as_tensor(mask)[None, ..., None]
    net = LipschitzUNet(8, num_output_channels=8, width=16)
    res = make_dip_fit(net, DipConfig(num_iter=3, learning_rate=1e-5))(z, y, m, init=p, chunk=FIT_CHUNK)
    args = (z[0].permute(2, 0, 1), y[0].permute(2, 0, 1), m[0, ..., 0], _setup())
    want = lip.dip_fit(p, *args, n_iters=3).out
    first = lip.dip_fit(p, *args, n_iters=1).out
    assert res.n_iters == 3
    assert _gap(res.out[0].permute(2, 0, 1), want) < FIT_TOL
    assert _gap(first, want) > 50 * FIT_TOL  # the fit moved far beyond the tolerance


def test_one_dip_1lip_outer_step_matches_the_reference():
    noisy, mask, _ = inputs.synthetic_sample(36, 36, 36, seed=5)
    D = inputs.load_dictionary(ROOT / "artifacts" / "dictionary_36x36_k512.npz")
    cfg = program.preset("dip_1lip", outer_iters=1, net_width=16)
    cfg = cfg.__class__(**{**cfg.__dict__,
                           "sparse": cfg.sparse.__class__(**{**cfg.sparse.__dict__, "n_iter": 4}),
                           "dip": cfg.dip.__class__(**{**cfg.dip.__dict__, "num_iter": 3, "learning_rate": 1e-5})})
    init = _params(36, 16, 4)
    solver = program.Solver(program.HsiSample(noisy=noisy, mask=mask), D, cfg, device="cpu",
                            dip_init=lambda itr: init)
    state, aux = solver.step(solver.init_state())
    s = _setup()
    pr = ref.problem(noisy, mask, D, s, "cpu")
    start = ref.initial_state(pr)
    fit = lip.dip_prox(start, pr, s, init, dip_iters=aux.dip_iters)
    want = ref.step(start, pr, s, U=fit.out).state
    assert aux.dip_iters == fit.n_iters == 3
    assert _gap(aux.U, fit.out) < FIT_TOL
    for got, w in zip((state.X, state.lambda1, state.lambda2), want):
        assert _gap(got, w) < FIT_TOL


# -- the cell on the CPU --------------------------------------------------------

# the card script that plants the fault ``sn_omitted``: the spectral norm left out
_spec = importlib.util.spec_from_file_location("readings_1lip", ROOT / "scripts" / "readings_1lip.py")
readings_1lip = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(readings_1lip)

SMALL = {"problem": {"bands": 36},
         "cell": {"pool": 2, "steps_per_solve": 2, "checked_steps": 2, "trace_steps": 1},
         "solver": {"sparse": {"n_iter": 5}, "net_width": 8,
                    "dip": {"num_iter": 60, "buffer_size": 5, "patience": 5}}}


@pytest.mark.parametrize("fault", [None, "sn_omitted"])
def test_cell_runs_end_to_end_and_sees_the_spectral_norm_left_out(fault, monkeypatch):
    if fault:
        readings_1lip.sn_omitted(monkeypatch.setattr)
    result, compared = run.execute("dip_1lip.cube36", 2**31 + 5, 0.5, False, device="cpu", overrides=SMALL)
    assert result["attempted"] >= 1 and set(compared) == {"state_gap", "fit_loss_excess", "fit_u_gap", "net_gap"}
    if fault is None:
        assert result["correct"] and result["failed"] == 0, compared
        assert {"step_ms", "setup_s"} <= set(result["metrics"])
    else:
        assert not result["correct"] and compared["net_gap"][0] > compared["net_gap"][1], compared


def test_driver_records_the_counter_and_counts_the_1lip_fit():
    _, ctx, driver = run.build("dip_1lip.cube36", 11, "cpu", SMALL)
    driver.setup()
    rec = driver.request(0)
    width = ctx.cfg.net_width
    assert rec.info["power_products"] == 14 * 17
    fit = lip.fit_flops_per_iteration(36, 36, 36, width)
    sparse = driver.flops(rec) - fit * sum(rec.info["dip_iters"])
    assert sparse == 2 * (4 * 36 * 1296 * 512 * 5 + 2 * 36 * 1296 * 512)  # 36 blocks of 36 bands, 5 iterations
    assert set(driver.init(1, 1)) == set(driver.solvers[0].stages.dip_fit.model.state_dict())
    driver.release()


# -- the trace readers ----------------------------------------------------------

MS = 1_000_000


def _iv(name, start_ms, end_ms):
    return Interval(name, int(start_ms * MS), int(end_ms * MS))


def _fit_trace(products: int):
    """Two fits, 0-20 and 30-40 ms, with three graph launches between them;
    each replayed iteration runs 2 x ``products`` spectral-norm kernels of
    0.01 ms and four others of 0.1 ms, inside the spans; two more kernels
    lie outside them."""
    launches = (1, 9, 31)
    host = [_iv("dip.fit", 0, 20), _iv("dip.fit", 30, 40), _iv("cudaGraphLaunch", 50, 51)]
    host += [_iv("cudaGraphLaunch", t, t + 0.1) for t in launches]
    device = [_iv("void gemvNSP_kernel<float, float>", 45, 46), _iv("conv", 60, 61)]
    for t in launches:
        for j in range(products):
            at = t + 0.2 + j * 0.02
            device += [_iv("void gemvNSP_kernel<float, float, float, float, 1, 16>", at, at + 0.01),
                       _iv("void at::native::reduce_kernel<512, 1, ReduceOp<float, NormTwoOps<float>>>",
                           at + 0.01, at + 0.02)]
        device += [_iv(f"sm80_xmma_fprop_{k}", t + 5 + k * 0.1, t + 5.1 + k * 0.1) for k in range(3)]
        device += [_iv("internal::gemvx::kernel<int, int, float2, float2>", t + 5.3, t + 5.4)]  # cuDNN's FFT
    return Trace(device, host, 60 * MS)


def _run(trace, products):
    rec = Record(0.0, 1.0, tiles=0, steps=1, info={"dip_iters": [3], "power_products": products})
    return run.Run(trace=trace, records=[rec], cell={"trace_steps": 1})


def test_fit_kernels_per_iter_reads_operations_over_replays():
    trace = _fit_trace(5)
    assert run.load_metric("fit_kernels_per_iter.step")(_run(trace, 5)) == pytest.approx(2 * 5 + 4)
    assert run.load_metric("fit_kernels_per_iter.step")(_run(None, 5)) is None


def test_sn_share_reads_only_when_its_rule_matches_the_counter():
    read = run.load_metric("sn_pct.step")
    trace = _fit_trace(5)
    assert read(_run(trace, 5)) == pytest.approx(100.0 * 10 * 0.01 / (10 * 0.01 + 4 * 0.1), rel=1e-4)  # ns rounding
    assert read(_run(trace, 6)) is None  # a stale rule, or a count gone wrong, reads as absent
    wide = _fit_trace(50)
    norms = [iv for iv in wide.device if "NormTwoOps" in iv.name]
    lost = Trace([iv for iv in wide.device if iv is not norms[7]], wide.host, wide.window_ns)
    # the profiler lost one record of 300: the share still reads; a tenth more or less does not
    assert read(_run(lost, 50)) == pytest.approx(100.0 * 2.99 / (2.99 + 3 * 0.4), rel=1e-4)
    assert read(_run(wide, 45)) is None and read(_run(wide, 56)) is None
    assert read(_run(trace, None)) is None  # a program that does not count its products
    assert read(_run(None, 5)) is None


# Device operations of `dip.cube36`'s traced stretch, as the benchmark's
# ledger gives its breakdown on the card: names with spaces and angle
# brackets replaced, cut to 64 characters.
DIP_CUBE36_OPS = [
    "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_ti",
    "sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc",
    "void_at::native::elementwise_kernel_128__2__at::native::gpu_kern",
    "void_cudnn::detail::dgrad2d_alg1_1_float__0__6__7__5__4__5__fals",
    "sm80_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_ti",
    "void_cudnn::detail::dgrad2d_alg1_1_float__0__5__6__4__3__4__fals",
    "void_cudnn::bn_bw_1C11_singleread_float__512__true__1__2__0__cud",
    "void_cudnn::bn_fw_tr_1C11_singleread_float__512__true__1__2__0__",
    "void_at::native::vectorized_elementwise_kernel_4__at::native::_a",
]


def test_sn_rule_matches_no_kernel_of_the_skip128_cell():
    rule = run.load_metric("sn_pct.step").__globals__["is_sn_kernel"]
    assert not [n for n in DIP_CUBE36_OPS if rule(n)]
    assert not [n for n, _ in SKIP_FIT_KERNELS if rule(n)]


def test_sn_rule_picks_twice_the_products_of_the_card_trace():
    """On the card's names, the rule picks the 238 products (158 ``gemv``,
    80 ``dot_kernel``) and the 238 norms of a 1-Lip iteration, and neither
    the products' second halves nor cuDNN's complex ``gemv``."""
    rule = run.load_metric("sn_pct.step").__globals__["is_sn_kernel"]
    picked = {n: c for n, c in LIP_FIT_KERNELS if rule(n)}
    assert sum(picked.values()) == 2 * LipschitzUNet(128, num_output_channels=128).power_products
    assert sum(c for n, c in picked.items() if "NormTwoOps" in n) == 238
    assert not [n for n in picked if "float2" in n or "reduce_1Block" in n]


def test_new_modules_load_neither_jax_nor_the_jax_package():
    code = (
        "import json, sys; sys.path.insert(0, {here!r}); import run; "
        "import reference.lipschitz_unet, traffic.cube_steps_1lip; "
        "[run.load_metric(m) for m in ('fit_kernels_per_iter.step', 'sn_pct.step')]; "
        "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))"
    ).format(here=str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=ROOT, timeout=300)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "lrs_pnp_dip_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "lrs_pnp_dip_tpu"}


# Kernels of one replayed iteration of each net's fit inside `dip.fit`, with
# their counts an iteration, as the card's trace names them (H100, torch 2.11,
# CUDA 12.8; scripts/fit_kernel_names.py), each name cut to 100 characters.
LIP_FIT_KERNELS = [
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::BinaryFun', 308),
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::NormTwoOps<float, flo', 238),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctorOnSelf_add<float>, std::arr', 225),
    ('void gemvNSP_kernel<float, float, float, float, 1, 16, 4, 1024, false, cublasGemvParamsEx<int, cubla', 108),
    ('void dot_kernel<float, 128, 0, cublasDotParams<cublasGemvTensorStridedBatched<float const>, cublasGe', 80),
    ('void reduce_1Block_kernel<float, 128, 7, cublasGemvTensorStridedBatched<float>, cublasGemvTensorStri', 80),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::CUDAFunct', 52),
    ('std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float, float, float, float, f', 32),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::launch_clamp_sc', 27),
    ('memcpy32_post', 21),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::direct_co', 20),
    ('void gemvNSP_kernel<float, float, float, float, 1, 32, 4, 1024, false, cublasGemvParamsEx<int, cubla', 18),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::BUnaryFunctor<float, float, float, at:', 14),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::leaky_relu_kern', 14),
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::func_wrapper_t<float,', 27),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::AbsFunctor<float>, std::array<char*, 2', 13),
    ('void cudnn::bn_fw_tr_1C11_singleread<float, 512, true, 1, 2, 0>(cudnn::bn_fw_tr_1C11_args<float>)', 13),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::leaky_relu_back', 13),
    ('void cudnn::bn_bw_1C11_singleread<float, 512, true, 1, 2, 0>(cudnn::bn_bw_1C11_args<float>)', 13),
    ('void at::native::(anonymous namespace)::reflection_pad2d_out_kernel<float>(float const*, float*, lon', 10),
    ('void fft2d_r2c_16x16<float>(float2*, float const*, int, int, int, int, int, int, int, int)', 10),
    ('void cudnn::engines_precompiled::scalePackedTensor_kernel<float, float>(long, float*, float)', 10),
    ('sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize32x32x8_stage3_warpsize1x2x1_g', 9),
    ('Memset (Unknown)', 9),
    ('void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false, true, (cudnnKernelData', 8),
    ('void cudnn::detail::dgrad2d_alg1_1<float, 0, 5, 6, 4, 3, 4, false, true>(int, int, int, float const*', 7),
    ('void cudnn::cnn::wgrad_alg1_engine<float, float, 128, 5, 5, 3, 3, 3, false, false>(int, int, int, fl', 7),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::(anonymous namespace)::where_kernel_im', 6),
    ('void flip_filter<float, float>(float*, float const*, int, int, int, int)', 5),
    ('std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float2, float2, float2, float', 5),
    ('void fft2d_c2r_16x16<float, false>(float*, float2*, int, int, int, int, int, int, int, int, int, int', 5),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::(anonymou', 6),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<bool, bool, bool, at::na', 5),
    ('void at::native::(anonymous namespace)::upsample_nearest2d_out_frame<float, &at::native::nearest_nei', 4),
    ('sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_nhwc_tilesize32x32x8_stage3_warpsiz', 4),
    ('void at::native::(anonymous namespace)::upsample_nearest2d_backward_out_frame<float, float, &at::nat', 4),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::compare_scalar_kernel<long>(at::Tensor', 3),
    ('sm80_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize32x32x8_stage3_warpsize1x2x1_g', 3),
    ('void cudnn::winograd_nonfused::winogradWgradData4x4<float, float>(cudnn::winograd_nonfused::Winograd', 3),
    ('void cudnn::winograd_nonfused::winogradWgradDelta4x4<float, float>(cudnn::winograd_nonfused::Winogra', 3),
    ('sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_aligna4_alignc4_exec', 3),
    ('void cudnn::winograd_nonfused::winogradWgradOutput4x4<float, float>(cudnn::winograd_nonfused::Winogr', 3),
    ('void cudnn::detail::dgrad2d_alg1_1<float, 0, 6, 7, 5, 4, 5, false, true>(int, int, int, float const*', 3),
    ('memcpy128', 3),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::where_kernel_im', 4),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::pow_tensor_scal', 2),
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<float, float,', 2),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float, float, float, at:', 2),
    ('void cudnn::engines_precompiled::nhwcToNchwKernel<float, float, float, true, false, (cudnnKernelData', 2),
    ('void at::native::(anonymous namespace)::indexSelectSmallIndex<float, long, unsigned int, 1, 1, -2>(a', 2),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::BUnaryFunctor<long, long, long, at::na', 2),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::CUDAFunctorOnSelf_add<long>, std::arra', 2),
    ('void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::TensorIteratorB', 2),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, std::array<char*, ', 1),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::FillFunctor<long>, std::array<char*, 1', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::bitwise_not_kernel_cuda(at::TensorIter', 1),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::BUnaryFun', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, float, float, at:', 2),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::neg_kernel_cuda(at::TensorIteratorBase', 1),
    ('void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace):', 1),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::(anonymous namespace)::launch_clamp_sc', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::lerp_scalar_ker', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::addcmul_cuda_kernel(at::TensorIterator', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::sqrt_kernel_cuda(at::TensorIteratorBas', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, std::array<cha', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<long, long, bool, at::na', 1),
    ('void at::native::(anonymous namespace)::indexSelectSmallIndex<float, long, unsigned int, 2, 2, -2>(a', 1),
    ('void at::native::index_elementwise_kernel<128, 4, at::native::index_copy_kernel_impl<at::native::Opa', 1),
    ('void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, at::native::MeanOps<float, float,', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::CompareFunctor<', 1),
    ('memcpy_post', 1),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::CUDAFunctor_add<long>, std::array<char', 1),
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_contig<at::native::(anonymous n', 1),
]
SKIP_FIT_KERNELS = [
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::CUDAFunct', 84),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::direct_co', 37),
    ('void cudnn::bn_fw_tr_1C11_singleread<float, 512, true, 1, 2, 0>(cudnn::bn_fw_tr_1C11_args<float>)', 29),
    ('void cudnn::bn_bw_1C11_singleread<float, 512, true, 1, 2, 0>(cudnn::bn_bw_1C11_args<float>)', 29),
    ('void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, false, true, (cudnnKernelData', 28),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::leaky_relu_kern', 25),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::leaky_relu_back', 24),
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::func_wrapper_t<float,', 24),
    ('sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize32x32x8_stage3_warpsize1x2x1_g', 19),
    ('Memset (Device)', 16),
    ('void at::native::(anonymous namespace)::reflection_pad2d_out_kernel<float>(float const*, float*, lon', 15),
    ('sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_nhwc_tilesize32x32x8_stage3_warpsiz', 15),
    ('void cudnn::engines_precompiled::scalePackedTensor_kernel<float, float>(long, float*, float)', 13),
    ('Memcpy DtoD (Device -> Device)', 12),
    ('sm80_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize32x32x8_stage3_warpsize1x2x1_g', 11),
    ('void cudnn::detail::dgrad2d_alg1_1<float, 0, 5, 6, 4, 3, 4, false, true>(int, int, int, float const*', 10),
    ('void cudnn::cnn::wgrad_alg1_engine<float, float, 128, 5, 5, 3, 3, 3, false, false>(int, int, int, fl', 10),
    ('void fft2d_r2c_16x16<float>(float2*, float const*, int, int, int, int, int, int, int, int)', 8),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, std::array<char*, ', 7),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::(anonymous namespace)::where_kernel_im', 6),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, std::array<cha', 5),
    ('void at::native::(anonymous namespace)::upsample_nearest2d_out_frame<float, &at::native::nearest_nei', 5),
    ('void at::native::(anonymous namespace)::upsample_nearest2d_backward_out_frame<float, float, &at::nat', 5),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::(anonymou', 6),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<bool, bool, bool, at::na', 5),
    ('void flip_filter<float, float>(float*, float const*, int, int, int, int)', 4),
    ('std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float2, float2, float2, float', 4),
    ('void fft2d_c2r_16x16<float, false>(float*, float2*, int, int, int, int, int, int, int, int, int, int', 4),
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous namespace)::Opaqu', 4),
    ('void cudnn::engines_precompiled::nhwcToNchwKernel<float, float, float, true, false, (cudnnKernelData', 4),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::BinaryFun', 4),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::compare_scalar_kernel<long>(at::Tensor', 3),
    ('void cudnn::detail::dgrad2d_alg1_1<float, 0, 6, 7, 5, 4, 5, false, true>(int, int, int, float const*', 3),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::where_kernel_im', 4),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float, float, float, at:', 2),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::pow_tensor_scal', 2),
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<float, float,', 2),
    ('void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, false, false, true>(int, int, int', 2),
    ('void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, at::native::func_wrapper_t<float,', 2),
    ('void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace):', 2),
    ('void at::native::(anonymous namespace)::indexSelectSmallIndex<float, long, unsigned int, 1, 1, -2>(a', 2),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::BUnaryFunctor<long, long, long, at::na', 2),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::CUDAFunctorOnSelf_add<long>, std::arra', 2),
    ('void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::TensorIteratorB', 2),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::FillFunctor<long>, std::array<char*, 1', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, float, float, at:', 2),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::sqrt_kernel_cuda(at::TensorIteratorBas', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctorOnSelf_add<float>, std::arr', 1),
    ('void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, at::native::MeanOps<float, float,', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::bitwise_not_kernel_cuda(at::TensorIter', 1),
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<at::native::(anonymous namesp', 1),
    ('void convolve_common_engine_float_NHWC<float, float, 1024, 5, 5, 3, 3, 3, true, false, false, false,', 1),
    ('void cudnn::batchnorm_fwtr_nhwc_semiPersist<float, float, float, 512, 16, 2, 4, 1, 1, false, false, ', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::sigmoid_kernel_cuda(at::TensorIterator', 1),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::BUnaryFun', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::neg_kernel_cuda(at::TensorIteratorBase', 1),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::sigmoid_b', 1),
    ('void cudnn::batchnorm_bwtr_nhwc_semiPersist<float, float, float, 512, 16, 3, 4, 1, 1, true, 2>(cudnn', 1),
    ('void cudnn::winograd_nonfused::winogradWgradData4x4<float, float>(cudnn::winograd_nonfused::Winograd', 1),
    ('void cudnn::winograd_nonfused::winogradWgradDelta4x4<float, float>(cudnn::winograd_nonfused::Winogra', 1),
    ('sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_aligna4_alignc4_exec', 1),
    ('void cudnn::winograd_nonfused::winogradWgradOutput4x4<float, float>(cudnn::winograd_nonfused::Winogr', 1),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::(anonymous namespace)::launch_clamp_sc', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::lerp_scalar_ker', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::addcmul_cuda_kernel(at::TensorIterator', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<long, long, bool, at::na', 1),
    ('void at::native::(anonymous namespace)::indexSelectSmallIndex<float, long, unsigned int, 2, 2, -2>(a', 1),
    ('void at::native::index_elementwise_kernel<128, 4, at::native::index_copy_kernel_impl<at::native::Opa', 1),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::CompareFunctor<', 1),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::CUDAFunctor_add<long>, std::array<char', 1),
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_contig<at::native::(anonymous n', 1),
]
