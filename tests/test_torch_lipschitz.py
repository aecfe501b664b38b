"""The port's Lipschitz layers and Lipschitz U-Net against the JAX package.

Each flax module is initialised from a seed, its variables carried over as
numpy arrays, and both sides fed the same numpy input.  Tolerances: layers
within rtol 1e-5 / atol 1e-5 (rtol 1e-4 for sigma by power iteration, whose
reductions run in another order); the whole net within 1e-4 of max |out|
(measured 1e-5); gradients of the masked MSE within 2e-2 of each tensor's
max |grad| (measured: 2e-3 from f32 ordering through 14 normalised layers,
and 1e-2 in single elements at width 128, where one activation at the
LeakyReLU kink takes the other slope)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.data.masks import synthetic_sample as j_synthetic_sample
from lrs_pnp_dip_tpu.models import LipschitzUNet as JLipschitzUNet
from lrs_pnp_dip_tpu.models import lipschitz as jlip
from lrs_pnp_dip_tpu.solvers import admm as jadmm
from lrs_pnp_dip_tpu.utils import config as jconfig
from lrs_pnp_dip_tpu_torch.data import synthetic_sample
from lrs_pnp_dip_tpu_torch.models import (
    ConvOperatorNorm, DeepDecoder, Identity, LipschitzUNet, ResDecoder, ResNet, Skip,
    SNBatchNorm2d, SNConv2d, TextureNet, UNet, UNet3D, get_net, lipschitz_unet_params_from_flax,
)
from lrs_pnp_dip_tpu_torch.models import lipschitz as tlip
from lrs_pnp_dip_tpu_torch.solvers import Solver
from lrs_pnp_dip_tpu_torch.solvers.admm import default_net
from lrs_pnp_dip_tpu_torch.utils import config as tconfig

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _oihw(kernel):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1)))


def test_sigma_max_exact_and_power_match():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((12, 40)).astype(np.float32)
    u = rng.standard_normal(12).astype(np.float32)
    exact = float(tlip._sigma_max_exact(torch.from_numpy(w)))
    np.testing.assert_allclose(exact, float(jlip._sigma_max_exact(jnp.asarray(w))), rtol=1e-5)
    np.testing.assert_allclose(exact, np.linalg.svd(w, compute_uv=False)[0], rtol=1e-5)
    sigma, new_u = tlip._sigma_max_power(torch.from_numpy(w), torch.from_numpy(u), 8)
    j_sigma, j_u = jlip._sigma_max_power(jnp.asarray(w), jnp.asarray(u), 8)
    np.testing.assert_allclose(float(sigma), float(j_sigma), rtol=1e-4)
    np.testing.assert_allclose(new_u.numpy(), np.asarray(j_u), rtol=1e-4, atol=1e-5)
    assert float(sigma) <= exact * (1 + 1e-5)


@pytest.mark.parametrize("ln_lambda", [1.0, 0.5, 0.0], ids=["lip1", "lip0.5", "off"])
@pytest.mark.parametrize("sn_mode", ["exact", "power"])
def test_snconv2d_matches(sn_mode, ln_lambda):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 9, 6)).astype(np.float32)
    jm = jlip.SNConv2d(10, kernel_size=3, stride=2, ln_lambda=ln_lambda, pad="reflection", sn_mode=sn_mode)
    v = _np(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    params = {**v["params"], "kernel": 3.0 * v["params"]["kernel"], "bias": rng.standard_normal(10).astype(np.float32)}
    state = {k: s for k, s in v.items() if k != "params"}
    tm = SNConv2d(6, 10, kernel_size=3, stride=2, ln_lambda=ln_lambda, pad="reflection", sn_mode=sn_mode)
    with torch.no_grad():
        tm.weight.copy_(_oihw(params["kernel"]))
        tm.bias.copy_(torch.from_numpy(params["bias"]))
    has_u = sn_mode == "power" and ln_lambda > 0
    assert ("u" in dict(tm.named_buffers())) == has_u == bool(state)
    if has_u:
        tm.u.copy_(torch.from_numpy(np.array(v["sn_state"]["u"])))
    for _ in range(2):  # the second forward starts from the advanced u
        if state:
            ref, state = jm.apply({"params": params, **state}, jnp.asarray(x), mutable=list(state))
        else:
            ref = jm.apply({"params": params}, jnp.asarray(x))
        out = tm(_nchw(x))
        np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-5, atol=1e-5)
        if has_u:
            np.testing.assert_allclose(tm.u.numpy(), np.asarray(state["sn_state"]["u"]), rtol=1e-4, atol=1e-5)
    # sigma is detached: the gradient is that of a conv with a constant factor
    assert tm.weight.grad is None
    out.sum().backward()
    assert bool(torch.isfinite(tm.weight.grad).all())


def test_snconv2d_reset_draws_weight_and_u_from_the_generator():
    a = SNConv2d(4, 5)
    a.reset_parameters(torch.Generator().manual_seed(0))
    w, u = a.weight.detach().clone(), a.u.clone()
    a.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(a.weight, w) and torch.equal(a.u, u)
    assert float(a.weight.detach().abs().max()) <= (6.0 / 36) ** 0.5 and float(a.bias.abs().max()) == 0.0
    with pytest.raises(ValueError, match="sn_mode"):
        SNConv2d(4, 5, sn_mode="svd")


def test_snbatchnorm2d_matches_with_scales_above_one():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 5, 6)).astype(np.float32) * 3 + 1
    scale = np.array([0.5, -2.5, 1.0, 1.5, 0.1, 2.0], np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    for sigma, s in ((1.0, scale), (1.0, scale / 5), (4.0, scale)):  # max|scale| or sigma wins
        ref = jlip.SNBatchNorm2d(sigma=sigma).apply({"params": {"scale": s, "bias": bias}}, jnp.asarray(x))
        tm = SNBatchNorm2d(6, sigma=sigma)
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(s))
            tm.bias.copy_(torch.from_numpy(bias))
        out = tm(_nchw(x))
        np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-5, atol=1e-5)

    def j_loss(p):
        return jnp.sum(jlip.SNBatchNorm2d().apply({"params": p}, jnp.asarray(x)) ** 3)

    g = jax.grad(j_loss)({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)})
    tm = SNBatchNorm2d(6)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(scale))
        tm.bias.copy_(torch.from_numpy(bias))
    (tm(_nchw(x)) ** 3).sum().backward()
    # the maximum is detached, so the largest scale gets no extra gradient
    np.testing.assert_allclose(tm.weight.grad.numpy(), np.asarray(g["scale"]), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tm.bias.grad.numpy(), np.asarray(g["bias"]), rtol=1e-3, atol=1e-3)


def test_conv_operator_norm_matches():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, 7, 3)).astype(np.float32)
    jm = jlip.ConvOperatorNorm(5, kernel_size=3, target_norm=0.8, pad="reflection", power_iters=2)
    v = _np(jm.init(jax.random.PRNGKey(5), jnp.asarray(x)))
    tm = ConvOperatorNorm(3, 5, (8, 7), kernel_size=3, target_norm=0.8, pad="reflection", power_iters=2)
    np.testing.assert_allclose(_nhwc(tm.u), v["sn_state"]["u"], rtol=1e-6)  # ones / sqrt(numel)
    with torch.no_grad():
        tm.weight.copy_(_oihw(v["params"]["kernel"]))
    state = {"sn_state": v["sn_state"]}
    for _ in range(2):
        ref, state = jm.apply({"params": v["params"], **state}, jnp.asarray(x), mutable=["sn_state"])
        out = tm(_nchw(x))
        np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_nhwc(tm.u), np.asarray(state["sn_state"]["u"]), rtol=1e-4, atol=1e-6)


def _masked_mse_grads(jnet, variables, tnet, x, target, mask):
    state = {k: s for k, s in variables.items() if k != "params"}

    def j_loss(p):
        if state:
            out, _ = jnet.apply({"params": p, **state}, jnp.asarray(x), mutable=list(state))
        else:
            out = jnet.apply({"params": p}, jnp.asarray(x))
        return jnp.mean((jnp.asarray(target * mask) - out * jnp.asarray(mask)) ** 2)

    j_grads = _np(jax.jit(jax.grad(j_loss))(variables["params"]))
    pred = tnet(torch.from_numpy(x))
    loss = torch.mean((torch.from_numpy(target * mask) - pred * torch.from_numpy(mask)) ** 2)
    loss.backward()
    return j_grads, {n: p.grad for n, p in tnet.named_parameters()}, pred


@pytest.mark.parametrize(
    "sn_mode,size,width,bands",
    [
        ("power", 36, 128, 8),  # full width once, in the default sn_mode
        ("power", 36, 16, 8),
        ("exact", 36, 16, 8),
        ("power", 48, 8, 8),  # 48 -> ... -> 3 -> 6->5, resized to 6; 12->11, resized to 12
        ("exact", 48, 8, 8),
    ],
    ids=["power-36_width128", "power-36_width16", "exact-36_width16", "power-48_resized", "exact-48_resized"],
)
def test_lipschitz_unet_matches_by_transplant(sn_mode, size, width, bands):
    rng = np.random.default_rng(6)
    x = rng.random((1, size, size, bands), dtype=np.float32)
    target = rng.random((1, size, size, bands), dtype=np.float32)
    mask = (rng.random((1, size, size, 1)) > 0.1).astype(np.float32)
    jnet = JLipschitzUNet(num_output_channels=bands, width=width, sn_mode=sn_mode)
    v = _np(jax.jit(jnet.init)(jax.random.PRNGKey(7), jnp.asarray(x)))
    state = {k: s for k, s in v.items() if k != "params"}
    if state:
        ref, new_state = jax.jit(lambda v: jnet.apply(v, jnp.asarray(x), mutable=list(state)))(v)
    else:
        ref = jax.jit(lambda v: jnet.apply(v, jnp.asarray(x)))(v)
    tnet = LipschitzUNet(bands, num_output_channels=bands, width=width, sn_mode=sn_mode)
    sd = lipschitz_unet_params_from_flax(v["params"], v.get("sn_state"))
    assert set(sd) == set(tnet.state_dict())
    tnet.load_state_dict(sd)
    j_grads, t_grads, pred = _masked_mse_grads(jnet, v, tnet, x, target, mask)
    ref = np.asarray(ref)
    assert pred.shape == (1, size, size, bands)
    np.testing.assert_allclose(pred.detach().numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    if state:
        for name, sub in new_state["sn_state"].items():
            np.testing.assert_allclose(
                getattr(tnet, name).u.numpy(), np.asarray(sub["u"]), rtol=1e-4, atol=1e-5
            )
    # a conv bias in front of a batch norm has gradient 0 up to rounding: both
    # sides must say so (under 1e-5 of the net's largest gradient, measured 7e-7)
    largest = max(np.abs(g).max() for sub in j_grads.values() for g in sub.values())
    for name, sub in j_grads.items():
        pairs = (("kernel", "weight"), ("bias", "bias")) if name.startswith("SNConv") else (
            ("scale", "weight"), ("bias", "bias"))
        for jk, tk in pairs:
            g_ref = sub[jk].transpose(3, 2, 0, 1) if jk == "kernel" else sub[jk]
            g = t_grads[f"{name}.{tk}"].numpy()
            if jk == "bias" and name.startswith("SNConv") and name != "SNConv2d_13":
                assert max(np.abs(g).max(), np.abs(g_ref).max()) < 1e-5 * largest, name
            else:
                np.testing.assert_allclose(
                    g, g_ref, rtol=0, atol=2e-2 * np.abs(g_ref).max(), err_msg=f"{name}.{tk}"
                )


def test_nearest_exact_is_the_rule_of_jax_image_resize():
    """5 -> 6: jax samples at floor((i + 0.5) * 5 / 6); torch's 'nearest'
    samples at floor(i * 5 / 6) and differs in two of six indices."""
    row = np.arange(5, dtype=np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(row), (6,), method="nearest"))
    t = torch.from_numpy(row)[None, None, None]
    exact = torch.nn.functional.interpolate(t, size=(1, 6), mode="nearest-exact").flatten().numpy()
    plain = torch.nn.functional.interpolate(t, size=(1, 6), mode="nearest").flatten().numpy()
    np.testing.assert_array_equal(exact, ref)
    assert int((plain != ref).sum()) == 2


def test_lipschitz_unet_reset_is_reproducible_and_bounded():
    net = LipschitzUNet(8, num_output_channels=8, width=8)
    net.reset_parameters(torch.Generator().manual_seed(0))
    first = {k: t.clone() for k, t in net.state_dict().items()}
    x = torch.rand((1, 36, 36, 8), generator=torch.Generator().manual_seed(1))
    net(x)
    assert not torch.equal(net.SNConv2d_0.u, first["SNConv2d_0.u"])  # a forward advances u
    net.reset_parameters(torch.Generator().manual_seed(0))
    for k, t in net.state_dict().items():
        assert torch.equal(t, first[k]), k


def test_one_dip_1lip_outer_step_matches_jax():
    """One `dip_1lip` outer step, the DIP fit starting from the JAX step's
    own init (params and power-iteration vectors), as the `dip` test of
    ``tests/test_torch_solver.py``.  The fit takes 3 iterations at lr 1e-4:
    Adam's first step moves every parameter by lr * sign(grad), and in this
    narrow net a handful of gradients at rounding level have another sign in
    the two frameworks (measured: 6 of 4,800 values, one of them a batch
    norm bias, of which a layer has 8).  At lr 0.01 that alone moves U by 2%
    after one step (as much as feeding the port's own fit the same values
    from another buffer does), so only a small step compares value for
    value; the power iteration's vectors still advance at every forward.  X
    and the duals within 2e-3 of their scale (measured 6e-4), MPSNR within 1e-2 dB."""
    kw = dict(variant="dip_1lip", mu1=0.1, mu2=0.1, block_size=6, stride=6, net_width=8)
    dip = dict(num_iter=3, buffer_size=2, patience=5, learning_rate=1e-4)
    t_cfg = tconfig.SolverConfig(sparse=tconfig.SparseProxConfig(n_iter=20), dip=tconfig.DipConfig(**dip), **kw)
    j_cfg = jconfig.SolverConfig(sparse=jconfig.SparseProxConfig(n_iter=20), dip=jconfig.DipConfig(**dip), **kw)
    rng = np.random.default_rng(0)
    D = rng.standard_normal((36, 48)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    s_t = synthetic_sample(36, 36, 12, missing=0.1, seed=3)
    s_j = j_synthetic_sample(36, 36, 12, missing=0.1, seed=3)

    jnet = jadmm.default_net(j_cfg, 12)
    j_step = jax.jit(jadmm.build_step(j_cfg, s_j.shape, net=jnet))
    j_state = jadmm.init_state(s_j, seed=0)
    _, dip_key = jax.random.split(j_state.key)
    fit_key, _ = jax.random.split(dip_key)
    v = _np(jnet.init(fit_key, jnp.zeros((1, 36, 36, 12), jnp.float32)))
    init = lipschitz_unet_params_from_flax(v["params"], v["sn_state"])

    solver = Solver(s_t, D, t_cfg, device="cpu", dip_init=lambda itr: init)
    t_state, t_aux = solver.step(solver.init_state())
    j_state, j_aux = j_step(j_state, jadmm.make_consts(s_j, D, j_cfg))
    assert t_aux.dip_iters == int(j_aux.dip_iters)
    np.testing.assert_allclose(float(t_aux.mpsnr), float(j_aux.mpsnr), atol=1e-2)
    for ours, ref in ((t_state.X, j_state.X), (t_state.lambda1, j_state.lambda1), (t_state.lambda2, j_state.lambda2)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-3, atol=2e-3 * np.abs(ref).max())


def test_get_net_and_default_net():
    skip = get_net(16, "skip", pad="reflection", n_channels=16, skip_n33d=8, skip_n33u=8, num_scales=2)
    assert isinstance(skip, Skip)
    assert skip(torch.zeros((1, 12, 12, 16))).shape == (1, 12, 12, 16)
    lip = get_net(16, "lipschitz_unet", n_channels=16)
    assert isinstance(lip, LipschitzUNet) and lip.SNConv2d_13.weight.shape == (16, 128, 1, 1)
    ident = get_net(16, "identity")
    assert isinstance(ident, Identity)
    x = torch.rand((1, 4, 4, 16), generator=torch.Generator().manual_seed(0))
    assert torch.equal(ident(x), x)
    zoo = {"ResNet": ResNet, "texture_nets": TextureNet, "UNet": UNet, "UNet3D": UNet3D,
           "deep_decoder": DeepDecoder, "res_decoder": ResDecoder}
    for key, cls in zoo.items():
        net = get_net(16, key, n_channels=16)
        assert type(net) is cls
        first = next(p for p in net.parameters() if p.ndim > 1)
        assert first.shape[1] == 16  # input_depth is the first layer's input width
    with pytest.raises(ValueError, match="unknown net_type"):
        get_net(16, "transformer")
    assert isinstance(default_net(tconfig.dip_preset(), 16), Skip)
    one_lip = default_net(tconfig.dip_1lip_preset(net_width=8, sn_mode="exact"), 16)
    assert isinstance(one_lip, LipschitzUNet) and one_lip.SNConv2d_0.sn_mode == "exact"
    assert isinstance(default_net(tconfig.dip_preset(dip_net="lipschitz_unet"), 16), LipschitzUNet)
    assert default_net(tconfig.lrs_pnp_preset(), 16) is None
    assert isinstance(default_net(tconfig.dip_preset(dip_net="deep_decoder"), 16), DeepDecoder)
