"""The port's DIP model zoo against the JAX package's: every ``get_net`` key,
the shared building blocks' options (activations, pads, down- and upsample
modes, mean-only batch norm, the fixed-kernel downsampler), the attention
blocks, the generic flax transplant, and the DIP solve with each key.

Each flax module is initialised from a seed, its parameters (batch-norm
scales and every bias redrawn, so that a layout fault cannot hide behind
ones and zeros) carried over by ``params_from_flax``, and both sides fed the
same numpy input.  Tolerances: forward max |delta| <= 1e-4 of max |out|;
parameter gradients of a masked MSE within 1e-2 of the largest gradient and,
for every tensor whose gradient reaches 1e-3 of the largest, a relative L2
error under 2e-2 (as for skip-128 in ``tests/test_torch_skip.py``: train-mode
batch norms over a few pixels amplify f32 summation order; conv biases in
front of a batch norm have a zero gradient in exact arithmetic, so theirs is
rounding noise and only the absolute bound applies).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu import models as jmodels
from lrs_pnp_dip_tpu.data.masks import synthetic_sample as j_synthetic_sample
from lrs_pnp_dip_tpu.models import common as jcommon
from lrs_pnp_dip_tpu.solvers import admm as jadmm
from lrs_pnp_dip_tpu.utils import config as jconfig
from lrs_pnp_dip_tpu_torch import models as tmodels
from lrs_pnp_dip_tpu_torch.data import synthetic_sample
from lrs_pnp_dip_tpu_torch.models import common as tcommon
from lrs_pnp_dip_tpu_torch.models import params_from_flax
from lrs_pnp_dip_tpu_torch.solvers import Solver
from lrs_pnp_dip_tpu_torch.utils import config as tconfig

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

FORWARD_TOL = 1e-4  # of max |out|
GRAD_ABS = 1e-2  # of the largest gradient
GRAD_REL_L2 = 2e-2  # per tensor whose gradient reaches 1e-3 of the largest


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _redraw(tree, rng):
    """Every bias and norm scale drawn anew: scales U(0.5, 1.5), biases
    U(-0.3, 0.3)."""
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out[name] = _redraw(sub, rng)
        elif name in ("scale",) or name.startswith("bn_scale"):
            out[name] = rng.uniform(0.5, 1.5, sub.shape).astype(np.float32)
        elif name == "bias" or name.startswith("bn_bias"):
            out[name] = rng.uniform(-0.3, 0.3, sub.shape).astype(np.float32)
        else:
            out[name] = np.asarray(sub, np.float32)
    return out


def _compare_net(jnet, tnet, x, seed=0):
    """Forward and masked-MSE gradients of the flax net and the port's, the
    port's weights carried over from the flax init.  Returns (forward
    error over max |out|, worst relative L2 gradient error)."""
    rng = np.random.default_rng(seed)
    # jitted: flax's init and grad take some 20 s each op by op on the CPU
    params = _redraw(_np(jax.jit(jnet.init)(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]), rng)
    tnet.load_state_dict(params_from_flax(params, tnet))

    j_out = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    t_out = tnet(torch.from_numpy(x))
    assert t_out.shape == j_out.shape
    scale = np.abs(j_out).max()
    fwd = float(np.abs(t_out.detach().numpy() - j_out).max()) / scale
    assert fwd <= FORWARD_TOL, fwd

    target = rng.random(j_out.shape).astype(np.float32)
    mask = (rng.random(j_out.shape) > 0.1).astype(np.float32)

    def j_loss(p):
        out = jnet.apply({"params": p}, jnp.asarray(x))
        return jnp.mean((out * mask - target * mask) ** 2)

    j_grads = params_from_flax(_np(jax.jit(jax.grad(j_loss))(params)), tnet)
    loss = torch.mean((t_out * torch.from_numpy(mask) - torch.from_numpy(target * mask)) ** 2)
    tnet.zero_grad()
    loss.backward()
    t_grads = dict(tnet.named_parameters())
    top = max(float(g.abs().max()) for g in j_grads.values())
    worst = 0.0
    for name, ref in j_grads.items():
        got = t_grads[name].grad
        assert float((got - ref).abs().max()) <= GRAD_ABS * top, name
        if float(ref.abs().max()) >= 1e-3 * top:
            rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
            assert rel < GRAD_REL_L2, (name, rel)
            worst = max(worst, rel)
    return fwd, worst


# (key, get_net keyword arguments, input shape): the sizes each net takes
# (the decoders grow their input 32 times; UNet3D takes a volume)
ZOO = [
    ("ResNet", dict(pad="reflection"), (1, 16, 16, 4)),
    ("skip", dict(pad="reflection", skip_n33d=8, skip_n33u=8, skip_n11=4, num_scales=3), (1, 16, 16, 4)),
    ("texture_nets", dict(pad="reflection"), (1, 32, 32, 3)),
    ("UNet", dict(pad="reflection"), (1, 32, 32, 4)),
    ("UNet3D", dict(), (1, 8, 8, 8, 1)),
    ("deep_decoder", dict(), (1, 2, 2, 4)),
    ("res_decoder", dict(), (1, 2, 2, 4)),
]


@pytest.mark.parametrize("key,kw,shape", ZOO, ids=[z[0] for z in ZOO])
def test_zoo_net_matches_flax_by_transplant(key, kw, shape):
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    c = shape[-1]
    fwd, rel = _compare_net(
        jmodels.get_net(c, key, n_channels=c, **kw), tmodels.get_net(c, key, n_channels=c, **kw), x
    )
    print(f"{key}: forward {fwd:.2e} of max|out|, gradients rel L2 {rel:.2e}")


# module options that get_net does not set
MODULE_OPTIONS = [
    ("UNet", dict(feature_scale=8, concat_x=True, upsample_mode="nearest"), (1, 32, 32, 3)),
    ("DeepDecoder", dict(channels=(16, 16, 16), upsample_first=False), (1, 3, 3, 4)),
]


@pytest.mark.parametrize("cls,kw,shape", MODULE_OPTIONS, ids=[m[0] for m in MODULE_OPTIONS])
def test_module_options_match_flax(cls, kw, shape):
    x = np.random.default_rng(7).random(shape).astype(np.float32)
    jnet = getattr(jmodels, cls)(num_output_channels=2, **kw)
    _compare_net(jnet, getattr(tmodels, cls)(shape[-1], num_output_channels=2, **kw), x)


# the skip net through each of the shared blocks' options
SKIP_OPTIONS = [
    dict(act_fun="Swish", upsample_mode="bilinear", downsample_mode="avg", pad="zero"),
    dict(act_fun="ELU", downsample_mode="max", pad="replication"),
    dict(act_fun="none", downsample_mode="lanczos2", pad="reflection"),
    dict(act_fun="LeakyReLU", downsample_mode="lanczos3", upsample_mode="bilinear", pad="zero"),
]


@pytest.mark.parametrize("options", SKIP_OPTIONS, ids=lambda o: "-".join(o.values()))
def test_skip_options_match_flax(options):
    kw = dict(skip_n33d=8, skip_n33u=8, skip_n11=4, num_scales=2, **options)
    x = np.random.default_rng(2).random((1, 16, 16, 4)).astype(np.float32)
    _compare_net(jmodels.get_net(4, "skip", n_channels=4, **kw), tmodels.get_net(4, "skip", n_channels=4, **kw), x)


def test_bilinear_and_trilinear_upsampling_are_jax_image_resize():
    """jax.image.resize's bilinear (half-pixel centres, edge taps
    renormalised) is the port's x2 upsampling (align_corners=False at a
    factor of 2, written as fixed-weight sums of shifted slices), edges
    included; trilinear likewise (UNet3D's).  Rounding only: 1e-6."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), method="bilinear"))
    got = tcommon.upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2), "bilinear").permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    v = rng.standard_normal((1, 3, 4, 5, 2)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(v), (1, 6, 8, 10, 2), method="trilinear"))
    got = tcommon.upsample_linear2x(torch.from_numpy(v).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown upsample mode"):
        tcommon.upsample2x(torch.zeros((1, 1, 2, 2)), "bicubic")


@pytest.mark.parametrize("kernel_type", ["lanczos2", "lanczos3", "gauss12", "gauss1sq2", "box"])
@pytest.mark.parametrize("factor", [2, 4])
def test_downsampler_kernel_bit_equal_and_forward(kernel_type, factor):
    from lrs_pnp_dip_tpu.models.downsampler import _resolve as j_resolve
    from lrs_pnp_dip_tpu_torch.models.downsampler import _resolve as t_resolve

    base, support, width, sigma = j_resolve(kernel_type, factor)
    assert t_resolve(kernel_type, factor) == (base, support, width, sigma)
    for phase in (0.5,) if base == "box" else (0.0, 0.5):
        ref = jmodels.get_kernel(factor, base, phase, width, support, sigma)
        got = tmodels.get_kernel(factor, base, phase, width, support, sigma)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    x = np.random.default_rng(4).random((1, 32, 32, 2)).astype(np.float32)
    for preserve in (False, True):
        jd = jmodels.Downsampler(factor=factor, kernel_type=kernel_type, phase=0.5, preserve_size=preserve)
        ref = np.asarray(jd.apply({}, jnp.asarray(x)))
        td = tmodels.Downsampler(factor=factor, kernel_type=kernel_type, phase=0.5, preserve_size=preserve)
        got = td(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert list(td.state_dict()) == []  # the fixed kernel is no parameter


@pytest.mark.parametrize("name", ["LeakyReLU", "Swish", "ELU", "none"])
def test_activations_match(name):
    x = np.linspace(-3, 3, 41, dtype=np.float32)
    np.testing.assert_allclose(
        tcommon.activation(name)(torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.activation(name)(jnp.asarray(x))), rtol=1e-6, atol=1e-7,
    )


def test_pads_mean_only_batch_norm_and_gen_noise():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for mode in ("reflection", "replication", "zero"):
        ref = np.asarray(jcommon.pad_input(jnp.asarray(x), 2, mode))
        np.testing.assert_array_equal(tcommon.pad_input(xt, 2, mode).permute(0, 2, 3, 1).numpy(), ref)
    v = rng.standard_normal((1, 4, 5, 6, 2)).astype(np.float32)  # NDHWC
    ref = np.asarray(jcommon.pad_input(jnp.asarray(v), 1, "replication"))
    got = tcommon.pad_input(torch.from_numpy(v).permute(0, 4, 1, 2, 3), 1, "replication")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), ref)

    jbn = jcommon.MeanOnlyBatchNorm()
    bias = rng.uniform(-1, 1, 3).astype(np.float32)
    ref = np.asarray(jbn.apply({"params": {"bias": bias}}, jnp.asarray(x)))
    tbn = tcommon.MeanOnlyBatchNorm(3)
    tbn.load_state_dict(params_from_flax({"bias": bias}, tbn))
    np.testing.assert_allclose(tbn(xt).permute(0, 2, 3, 1).detach().numpy(), ref, rtol=1e-5, atol=1e-6)

    noise = tcommon.GenNoise(7)(xt, generator=torch.Generator().manual_seed(0))
    again = tcommon.GenNoise(7)(xt, generator=torch.Generator().manual_seed(0))
    j_noise = jcommon.GenNoise(7).apply({}, jnp.asarray(x), rngs={"noise": jax.random.PRNGKey(0)})
    assert noise.permute(0, 2, 3, 1).shape == j_noise.shape and torch.equal(noise, again)
    with pytest.raises(ValueError, match="unknown downsample mode"):
        tcommon.Conv2d(3, 3, 3, stride=2, downsample_mode="bicubic")


def test_attention_blocks_match_flax():
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 5, 16)).astype(np.float32) for _ in range(3))
    mask = rng.random((2, 5, 5)) > 0.3
    mask[:, :, 0] = True  # every query sees a key
    jm = jmodels.MultiHeadAttention(n_head=4, d_model=16, d_k=8, d_v=6)
    params = _redraw(_np(jm.init(jax.random.PRNGKey(0), q, k, v)["params"]), rng)
    j_out, j_attn = jm.apply({"params": params}, q, k, v, mask=jnp.asarray(mask))
    tm = tmodels.MultiHeadAttention(n_head=4, d_model=16, d_k=8, d_v=6)
    tm.load_state_dict(params_from_flax(params, tm))
    t_out, t_attn = tm(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_attn.detach().numpy(), np.asarray(j_attn), rtol=1e-5, atol=1e-6)

    jf = jmodels.PositionwiseFeedForward(d_hid=24)
    fparams = _redraw(_np(jf.init(jax.random.PRNGKey(1), q)["params"]), rng)
    tf = tmodels.PositionwiseFeedForward(16, 24)
    tf.load_state_dict(params_from_flax(fparams, tf))
    np.testing.assert_allclose(
        tf(torch.from_numpy(q)).detach().numpy(), np.asarray(jf.apply({"params": fparams}, q)),
        rtol=1e-5, atol=1e-5,
    )
    out, attn = tmodels.scaled_dot_product_attention(*map(torch.from_numpy, (q, k, v)), temperature=2.0)
    j_out, j_attn = jmodels.scaled_dot_product_attention(q, k, v, temperature=2.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tmodels.sinusoid_position_encoding(9, 6).numpy(),
        np.asarray(jmodels.sinusoid_position_encoding(9, 6)),
    )


def test_params_from_flax_names_what_it_cannot_place():
    net = tmodels.get_net(3, "ResNet")
    params = _np(jmodels.get_net(3, "ResNet").init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"])
    assert set(params_from_flax(params, net)) == set(net.state_dict())
    with pytest.raises(KeyError, match="Conv2d_9"):
        params_from_flax({**params, "Conv2d_9": {"Conv_0": {"kernel": np.zeros((1, 1, 16, 3))}}}, net)
    with pytest.raises(KeyError, match="no value"):
        params_from_flax({k: v for k, v in params.items() if k != "BatchNorm2d_0"}, net)
    bad = {**params, "Conv2d_2": {"Conv_0": {**params["Conv2d_2"]["Conv_0"], "bias": np.zeros(5)}}}
    with pytest.raises(ValueError, match="Conv2d_2.bias"):
        params_from_flax(bad, net)


def _fit_key(j_state):
    """The key the JAX step's DIP fit initialises its net from."""
    _, dip_key = jax.random.split(j_state.key)
    return jax.random.split(dip_key)[0]


def test_one_dip_outer_step_with_resnet_matches_jax():
    """One `dip` outer step with ``dip_net='ResNet'``, the fit starting from
    the JAX step's own init (``params_from_flax``), 4 Adam iterations at lr
    1e-3.  X and the duals within 2e-3 of their scale, MPSNR within 1e-2 dB
    (the limits of the `dip` and `dip_1lip` steps in
    ``tests/test_torch_solver.py`` and ``tests/test_torch_lipschitz.py``)."""
    kw = dict(variant="dip", mu1=0.1, mu2=0.1, block_size=6, stride=6, dip_net="ResNet")
    dip = dict(num_iter=4, buffer_size=2, patience=5, learning_rate=1e-3)
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
    params = _np(jnet.init(_fit_key(j_state), jnp.zeros((1, 36, 36, 12), jnp.float32))["params"])
    net = tmodels.get_net(12, "ResNet", pad="reflection", n_channels=12)
    init = params_from_flax(params, net)
    solver = Solver(s_t, D, t_cfg, net=net, device="cpu", dip_init=lambda itr: init)
    t_state, t_aux = solver.step(solver.init_state())
    j_state, j_aux = j_step(j_state, jadmm.make_consts(s_j, D, j_cfg))
    assert t_aux.dip_iters == int(j_aux.dip_iters) == 4
    np.testing.assert_allclose(float(t_aux.mpsnr), float(j_aux.mpsnr), atol=1e-2)
    for ours, ref in ((t_state.X, j_state.X), (t_state.lambda1, j_state.lambda1), (t_state.lambda2, j_state.lambda2)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-3, atol=2e-3 * np.abs(ref).max())


def _outcome(run):
    try:
        run()
    except Exception as e:  # the test records which error each package raises
        return type(e).__name__
    return "runs"


# What one DIP outer step does with each key in the JAX package on the CPU
# (measured; 36x36 images, 6x6 for the decoders, whose 32-fold output would
# be 1152x1152 there): only ResNet, skip and lipschitz_unet keep the
# (1, H, W, B) shape of the iterate.  The port runs `identity` (its fit skips
# Adam when a net has no parameters); the JAX fit raises KeyError('params').
SOLVES = {
    "ResNet": ("runs", "runs"),
    "skip": ("runs", "runs"),
    "texture_nets": ("RuntimeError", "TypeError"),  # 32x32 output
    "UNet": ("RuntimeError", "TypeError"),  # 32x32 output
    "UNet3D": ("ValueError", "ZeroDivisionError"),  # 4-D input to a 3-D net
    "deep_decoder": ("RuntimeError", "TypeError"),  # 192x192 output
    "res_decoder": ("RuntimeError", "TypeError"),
    "identity": ("runs", "KeyError"),
}


@pytest.mark.parametrize("key", list(SOLVES))
def test_dip_net_keys_solve_where_jax_does(key):
    """Each ``dip_net`` key in one `dip` outer step (DIP fit capped at 2) in
    both packages: the same keys run, the same keys fail (lipschitz_unet is
    the `dip_1lip` net, pinned in ``tests/test_torch_lipschitz.py``)."""
    size = 6 if key in ("deep_decoder", "res_decoder") else 36
    kw = dict(variant="dip", block_size=6, stride=6, dip_net=key)
    t_cfg = tconfig.SolverConfig(sparse=tconfig.SparseProxConfig(n_iter=2), dip=tconfig.DipConfig(num_iter=2), **kw)
    j_cfg = jconfig.SolverConfig(sparse=jconfig.SparseProxConfig(n_iter=2), dip=jconfig.DipConfig(num_iter=2), **kw)
    D = np.random.default_rng(0).standard_normal((36, 48)).astype(np.float32)
    s_t = synthetic_sample(size, size, 12, missing=0.1, seed=3)
    s_j = j_synthetic_sample(size, size, 12, missing=0.1, seed=3)

    def port():
        solver = Solver(s_t, D, t_cfg, device="cpu")
        state, aux = solver.step(solver.init_state())
        assert state.X.shape == (size * size, 12) and bool(torch.isfinite(state.X).all())

    def jax_side():
        step = jax.jit(jadmm.build_step(j_cfg, s_j.shape))
        state, _ = step(jadmm.init_state(s_j, seed=0), jadmm.make_consts(s_j, D, j_cfg))
        assert np.isfinite(np.asarray(state.X)).all()

    assert (_outcome(port), _outcome(jax_side)) == SOLVES[key]
