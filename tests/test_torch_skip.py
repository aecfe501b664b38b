"""The port's skip-128 DIP net against the flax net, with the flax
parameters carried over by ``skip_params_from_flax``.

Tolerances: forward max |delta| < 1e-4 (the flax <-> reference-torch
transplant measures 3.9e-06).  Parameter gradients of the masked MSE: max
|delta| < 1e-2 of the largest gradient, and a relative L2 error < 2e-2 for
every tensor whose gradient reaches 1e-3 of the largest.  In float64 both
sides agree to 3e-8 relative; in float32 the deep train-mode BatchNorms (a
few pixels per channel at 3x3 and 2x2) amplify the summation-order
differences to about 0.5% (measured 7.2e-3 at most).  Conv biases that feed
a BatchNorm have a zero gradient in exact arithmetic, so theirs is rounding
noise and only the absolute bound applies."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lrs_pnp_dip_tpu.models import dip_skip_128 as j_skip_128
from lrs_pnp_dip_tpu_torch.models import Conv2d, dip_skip_128, skip_params_from_flax

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)


def _randomise_bn(params, rng):
    """BN scale U(0.5, 1.5), bias U(-0.3, 0.3): the defaults 1/0 would hide
    a scale-handling fault."""
    out = {}
    for name, sub in params.items():
        if name.startswith("BatchNorm2d_"):
            c = sub["scale"].shape
            out[name] = {
                "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.uniform(-0.3, 0.3, c).astype(np.float32),
            }
        elif isinstance(sub, dict):
            out[name] = _randomise_bn(sub, rng)
        else:
            out[name] = np.asarray(sub)
    return out


def _flatten(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = np.asarray(v)
    return flat


def test_skip_128_forward_and_grads_match_flax():
    rng = np.random.default_rng(0)
    x = rng.random((1, 36, 36, 128), dtype=np.float32)
    target = rng.random((1, 36, 36, 128), dtype=np.float32)
    mask = (rng.random((1, 36, 36, 1)) > 0.1).astype(np.float32)

    fnet = j_skip_128(128)
    params = jax.jit(fnet.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _randomise_bn(jax.tree.map(np.asarray, params), rng)

    def loss_fn(p):
        out = fnet.apply({"params": p}, jnp.asarray(x))
        return jnp.mean((target * mask - out * mask) ** 2), out

    (loss_j, out_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    tnet = dip_skip_128(128)
    tnet.load_state_dict(skip_params_from_flax(params), strict=True)
    out_t = tnet(torch.from_numpy(x))
    loss_t = torch.mean((torch.from_numpy(target * mask) - out_t * torch.from_numpy(mask)) ** 2)
    loss_t.backward()

    delta = np.abs(out_t.detach().numpy() - np.asarray(out_j)).max()
    assert delta < 1e-4, delta
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-4)

    grads_t = skip_params_from_flax(jax.tree.map(np.asarray, grads_j))
    named = dict(tnet.named_parameters())
    assert set(grads_t) == set(named)
    gmax = max(float(np.abs(g.numpy()).max()) for g in grads_t.values())
    for name, ref in grads_t.items():
        got = named[name].grad.numpy()
        ref = ref.numpy()
        assert np.abs(got - ref).max() < 1e-2 * gmax, name
        if np.abs(ref).max() >= 1e-3 * gmax:
            assert np.linalg.norm(got - ref) < 2e-2 * np.linalg.norm(ref), name


def test_port_init_matches_flax_init_rules():
    """Conv biases start at zero (flax's nn.Conv default, not torch's), conv
    kernels within +-1/sqrt(fan_in), BN scale 1 and bias 0."""
    net = dip_skip_128(128)
    gen = torch.Generator().manual_seed(3)
    net.reset_parameters(gen)
    convs = [m for m in net.modules() if isinstance(m, Conv2d)]
    assert len(convs) == 5 * 5 + 1
    for conv in convs:
        assert torch.count_nonzero(conv.bias) == 0
        fan_in = conv.weight.shape[1] * conv.weight.shape[2] * conv.weight.shape[3]
        bound = np.float32(1.0 / np.sqrt(fan_in))
        w = conv.weight.detach()
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.9 * bound  # uniform over the whole range
    for name, p in net.named_parameters():
        if ".BatchNorm2d_" in name:
            expected = 1.0 if name.endswith("weight") else 0.0
            assert torch.all(p == expected), name


def test_transplant_covers_the_flax_tree():
    """Every flax parameter lands on a port parameter of the matching shape."""
    fnet = j_skip_128(16)
    x = jnp.zeros((1, 36, 36, 16), jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(fnet.init)(jax.random.PRNGKey(1), x)["params"])
    state = skip_params_from_flax(params)
    assert len(state) == len(_flatten(params))
    tnet = dip_skip_128(16)
    tnet.load_state_dict(state, strict=True)
    k = params["_SkipScale_0"]["Conv2d_0"]["Conv_0"]["kernel"]  # HWIO
    np.testing.assert_array_equal(
        tnet._SkipScale_0.Conv2d_0.weight.detach().numpy(), k.transpose(3, 2, 0, 1)
    )
