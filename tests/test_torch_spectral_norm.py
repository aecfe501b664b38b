"""The 1-Lip U-Net's spectral norms taken for all its convs in one call
(``models/lipschitz.py:spectral_norms``), on the CPU: the grouped call, a
forward and a fit step give the per-conv path's bits, u advances once a
forward, and the kernel's plan (``ops/spectral_norm_cuda.py``) is the pure
arithmetic of its shared memory.  The kernel itself runs in
``tests/test_torch_cuda.py``."""

import pytest
import torch

from lrs_pnp_dip_tpu_torch.models import LipschitzUNet, SNConv2d
from lrs_pnp_dip_tpu_torch.models import lipschitz
from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, spectral_norm_cuda
from lrs_pnp_dip_tpu_torch.ops.cuda_kernel import capture_marks
from lrs_pnp_dip_tpu_torch.ops.spectral_norm_cuda import SN_KERNEL, plan_spectral_norm, smem_bytes
from lrs_pnp_dip_tpu_torch.solvers import DipFit
from lrs_pnp_dip_tpu_torch.utils.config import DipConfig

torch.set_num_threads(1)

# (out, in, k) of the `dip_1lip` preset's 14 convs (128 bands, width 128)
PRESET_CONVS = [(128, 128, 3)] * 8 + [(128, 128, 2)] * 2 + [(128, 128, 3)] * 2 + [(128, 128, 1)] * 2


def _weights_and_us(convs, seed):
    gen = torch.Generator().manual_seed(seed)
    weights = [torch.randn((o, i, k, k), generator=gen) * 0.1 for o, i, k in convs]
    us = [torch.randn(o, generator=gen) for o, _, _ in convs]
    return weights, us


def _per_module(net):
    """The net with each conv taking its own factor, as before the grouped call."""
    return lambda x: net.layers(x, lambda i, y: getattr(net, f"SNConv2d_{i}")(y))


@pytest.mark.parametrize(
    "convs,ln_lambda,n_iter",
    [
        ([(16, 16, 3), (16, 16, 3), (16, 16, 2), (16, 16, 1), (8, 16, 1)], 1.0, 8),
        ([(19, 3, 3), (5, 7, 1)], 0.5, 8),
        ([(12, 4, 3)], 1.0, 0),
        (PRESET_CONVS[7:], 1.0, 8),
    ],
    ids=["width16", "odd", "no_steps", "preset_shapes"],
)
def test_grouped_call_equals_the_per_conv_loop(convs, ln_lambda, n_iter):
    weights, us = _weights_and_us(convs, seed=len(convs))
    want_us = [u.clone() for u in us]
    table = lipschitz.spectral_norms(weights, us, [ln_lambda] * len(convs), [n_iter] * len(convs))
    assert table.shape == (2, len(convs)) and table.dtype == torch.float32
    for g, (w, u) in enumerate(zip(weights, want_us)):
        sigma, new_u = lipschitz._sigma_max_power(w.reshape(w.shape[0], -1), u, n_iter)
        assert torch.equal(table[0, g], sigma)
        assert torch.equal(table[1, g], torch.clamp(sigma / ln_lambda, min=1.0))
        assert torch.equal(us[g], new_u)


@pytest.mark.parametrize("sn_mode,ln_lambda", [("power", 1.0), ("power", 0.2), ("exact", 1.0), ("power", 0.0)])
def test_lipschitz_unet_forward_equals_the_per_module_path(sn_mode, ln_lambda):
    """Output, gradients and every u of one forward and backward."""
    nets = [LipschitzUNet(8, num_output_channels=8, width=16, ln_lambda=ln_lambda, sn_mode=sn_mode)
            for _ in range(2)]
    nets[0].reset_parameters(torch.Generator().manual_seed(3))
    nets[1].load_state_dict(nets[0].state_dict())
    x = torch.rand((1, 36, 36, 8), generator=torch.Generator().manual_seed(4))
    outs = []
    for net, forward in ((nets[0], nets[0]), (nets[1], _per_module(nets[1]))):
        out = forward(x)
        (out ** 2).mean().backward()
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    for (name, a), b in zip(nets[0].named_parameters(), nets[1].parameters()):
        assert torch.equal(a.grad, b.grad), name
    for (name, a), b in zip(nets[0].named_buffers(), nets[1].buffers()):
        assert torch.equal(a, b), name


def test_a_fit_equals_the_per_module_path():
    """Three Adam iterations of the host-stepped DIP fit, the grouped net
    against the per-module one: output, loss, parameters and u alike."""

    class PerModule(LipschitzUNet):
        def forward(self, x):
            return _per_module(self)(x)

    gen = torch.Generator().manual_seed(5)
    x, target = torch.rand((1, 36, 36, 8), generator=gen), torch.rand((1, 36, 36, 8), generator=gen)
    mask = (torch.rand((1, 36, 36, 1), generator=gen) > 0.1).float()
    results, nets = [], []
    for cls in (LipschitzUNet, PerModule):
        net = cls(8, num_output_channels=8, width=16)
        fit = DipFit(net, DipConfig(num_iter=3, patience=10**9, learning_rate=0.01))
        results.append(fit(x, target, mask, generator=torch.Generator().manual_seed(6)))
        nets.append(net)
    assert results[0].n_iters == results[1].n_iters == 3
    assert torch.equal(results[0].out, results[1].out) and torch.equal(results[0].loss, results[1].loss)
    for (name, a), b in zip(nets[0].state_dict().items(), nets[1].state_dict().values()):
        assert torch.equal(a, b), name


def test_a_forward_takes_one_grouped_call_and_advances_u_once(monkeypatch):
    net = LipschitzUNet(8, num_output_channels=8, width=16)
    net.reset_parameters(torch.Generator().manual_seed(7))
    convs = [getattr(net, f"SNConv2d_{i}") for i in range(14)]
    before = [c.u.clone() for c in convs]
    calls = []
    norms = lipschitz.spectral_norms

    def counted(weights, us, ln_lambdas, n_iters):
        calls.append(len(weights))
        return norms(weights, us, ln_lambdas, n_iters)

    monkeypatch.setattr(lipschitz, "spectral_norms", counted)
    net(torch.rand((1, 36, 36, 8), generator=torch.Generator().manual_seed(8)))
    assert calls == [14]
    assert net.power_products == 14 * 17
    for conv, u in zip(convs, before):
        w2d = conv.weight.detach().reshape(conv.weight.shape[0], -1)
        assert torch.equal(conv.u, lipschitz._sigma_max_power(w2d, u, 8)[1])
    conv = SNConv2d(4, 5)  # alone: a group of one
    conv(torch.rand((1, 4, 6, 6)))
    assert calls == [14, 1]


def test_off_the_cpu_the_call_goes_to_the_kernel_and_never_falls_back():
    """A tensor on another device than the CPU reaches the kernel's
    wrapper, which takes CUDA tensors only: it raises, with no plain
    fallback."""
    w, u = torch.empty((4, 9), device="meta"), torch.empty(4, device="meta")
    launches = SN_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA device"):
        lipschitz.spectral_norms([w], [u], [1.0], [8])
    with pytest.raises(ValueError, match="CUDA device"):
        SN_KERNEL.launch([torch.zeros((4, 9))], [torch.zeros(4)], [1.0], [8])
    assert SN_KERNEL.launches == launches and SN_KERNEL._lib is None  # nothing built
    assert ISTA_KERNEL._lib is None and {SN_KERNEL, ISTA_KERNEL} <= set(capture_marks())


def _preset_shapes(width=128, bands=128):
    return [(width if i < 13 else bands, (bands if i == 0 else width) * k * k)
            for i, (_, _, k) in enumerate(PRESET_CONVS)]


@pytest.mark.parametrize(
    "shapes,cluster_size,smem",
    [
        (_preset_shapes(), 8, 4 * (128 * 148 + 2 * 128 + 256 + 1024 + 148 + 12)),
        ([(128, 1152)], 8, 82560),
        ([(128, 512)], 4, 4 * (128 * 132 + 256 + 256 + 1024 + 132 + 12)),
        ([(128, 128)], 1, 4 * (128 * 132 + 256 + 256 + 1024 + 132 + 12)),
        (_preset_shapes(width=16, bands=8), 1, 4 * (16 * 148 + 32 + 256 + 1024 + 148 + 12)),
        ([(19, 27)], 1, 4 * (19 * 28 + 40 + 256 + 1024 + 28 + 12)),
        ([(300, 2000), (128, 1152)], 16, 4 * (300 * 132 + 2 * 300 + 300 + 1024 + 132 + 12)),
    ],
    ids=["preset", "n1152", "n512", "n128", "width16", "odd19x27", "wide"],
)
def test_plan_picks_the_cluster_and_counts_shared_memory(shapes, cluster_size, smem):
    plan = plan_spectral_norm(shapes)
    assert (plan.cluster_size, plan.smem_bytes) == (cluster_size, smem)
    assert plan.smem_bytes == max(smem_bytes(m, n, cluster_size) for m, n in shapes)
    assert plan.shapes == tuple(shapes)
    seg = -(-max(n for _, n in shapes) // cluster_size)
    assert seg <= 144 or cluster_size == spectral_norm_cuda.MAX_CLUSTER


@pytest.mark.parametrize(
    "shapes,match",
    [
        ([(512, 16384)], "shared memory"),
        ([(128, 1152), (1024, 4096)], "shared memory"),
        ([], "1 to 64"),
        ([(8, 8)] * 65, "1 to 64"),
        ([(0, 8)], "m, n >= 1"),
    ],
    ids=["too_wide", "one_too_wide", "empty", "too_many", "empty_weight"],
)
def test_plan_refuses_what_the_kernel_does_not_take(shapes, match):
    with pytest.raises(ValueError, match=match):
        plan_spectral_norm(shapes)
