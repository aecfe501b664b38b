"""The port's generic DIP fit (solvers/fit.py), get_dip_out and get_noise
against the JAX package.

``adam`` and ``sgd`` start from the JAX fit's own init, a two-layer conv net
transplanted from flax, and are compared over 5 steps: losses and the last
output within rtol 1e-4 (Adam's and SGD's updates are the same arithmetic
in both).  ``lbfgs`` takes other steps in the two packages (optax's zoom
line search and scaled initial preconditioner against torch's strong-Wolfe
search), so it is compared where both must land: the least-squares minimum
of a linear model, within 1e-5 after 20 steps.  get_dip_out: 6 Adam steps at
rtol 1e-4.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from lrs_pnp_dip_tpu.solvers import dip as jdip
from lrs_pnp_dip_tpu.utils.noise import get_noise as j_get_noise
from lrs_pnp_dip_tpu_torch.solvers import FitConfig, find_best_update, fit, get_dip_out
from lrs_pnp_dip_tpu_torch.utils import get_noise

# the JAX package's solvers/__init__ exports the function fit under the module's name
jfit = importlib.import_module("lrs_pnp_dip_tpu.solvers.fit")

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

class _JConvNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = fnn.relu(fnn.Conv(6, (3, 3), padding="SAME")(x))
        return fnn.Conv(3, (3, 3), padding="SAME")(x)


class ConvNet(torch.nn.Module):
    """_JConvNet in torch, NHWC in and out like the port's nets."""

    def __init__(self):
        super().__init__()
        self.conv0 = torch.nn.Conv2d(4, 6, 3, padding=1)
        self.conv1 = torch.nn.Conv2d(6, 3, 3, padding=1)

    def forward(self, x):
        return self.conv1(torch.relu(self.conv0(x.permute(0, 3, 1, 2)))).permute(0, 2, 3, 1)


def _transplant(params):
    out = {}
    for i in range(2):
        out[f"conv{i}.weight"] = torch.tensor(np.asarray(params[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1))
        out[f"conv{i}.bias"] = torch.tensor(np.asarray(params[f"Conv_{i}"]["bias"]))
    return out


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    x = rng.random((1, 8, 8, 4)).astype(np.float32)
    y = rng.random((1, 8, 8, 3)).astype(np.float32)
    mask = (rng.random((1, 8, 8, 1)) > 0.3).astype(np.float32)
    fnet = _JConvNet()
    key = jax.random.PRNGKey(0)
    init_key, _ = jax.random.split(key)  # as the JAX fit splits its key
    params = jax.jit(fnet.init)(init_key, jnp.asarray(x))["params"]
    return x, y, mask, fnet, key, _transplant(params)


def _down(out):
    """A measurement map: 2x2 average pooling."""
    return out.reshape(1, 4, 2, 4, 2, 3).mean(axis=(2, 4))


CASES = {
    "adam": dict(),
    "adam-decay": dict(lr_decay_epoch=2, lr_decay_rate=0.5),
    "sgd": dict(optimizer="sgd", lr=0.05),
    "sgd-decay": dict(optimizer="sgd", lr=0.05, lr_decay_epoch=2),
    "adam-opt-input": dict(opt_input=True),
    "adam-mask": dict(masked=True),
    "sgd-apply-f": dict(optimizer="sgd", lr=0.05, apply_f=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_matches_jax_by_transplant(problem, case):
    x, y, mask, fnet, key, init = problem
    kw = dict(CASES[case])
    masked, apply_f = kw.pop("masked", False), kw.pop("apply_f", False)
    cfg = {"num_iter": 5, "lr": 0.01, **kw}
    target = _down(y) if apply_f else y
    j_res = jfit.fit(
        fnet, key, jnp.asarray(x), jnp.asarray(target), mask=jnp.asarray(mask) if masked else None,
        apply_f=_down if apply_f else None, config=jfit.FitConfig(**cfg),
    )
    t_res = fit(
        ConvNet(), None, x, target, mask=mask if masked else None,
        apply_f=_down if apply_f else None, config=FitConfig(**cfg), init=init, device="cpu",
    )
    losses = np.asarray(j_res.losses)
    np.testing.assert_allclose(t_res.losses.numpy(), losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    out = np.asarray(j_res.out)
    np.testing.assert_allclose(t_res.out.numpy(), out, rtol=1e-4, atol=1e-4 * np.abs(out).max())
    np.testing.assert_allclose(t_res.net_input.numpy(), np.asarray(j_res.net_input), rtol=1e-4, atol=1e-6)
    if kw.get("opt_input"):
        assert not np.array_equal(t_res.net_input.numpy(), x)


def test_fit_input_noise_decays_and_best_params_are_a_snapshot(problem):
    """reg_noise_std draws from the caller's generator (two fits from equal
    generators give equal bits) and decays every reg_noise_decayevery
    steps; find_best keeps a copy of the parameters the best loss was
    computed at."""
    x, y, _, _, _, init = problem
    cfg = FitConfig(num_iter=4, reg_noise_std=0.5, reg_noise_decay=0.0, reg_noise_decayevery=2)
    runs = [fit(ConvNet(), torch.Generator().manual_seed(3), x, y, config=cfg,
                init=init, device="cpu") for _ in range(2)]
    torch.testing.assert_close(runs[0].losses, runs[1].losses, rtol=0, atol=0)
    quiet = fit(ConvNet(), None, x, y, config=dataclasses.replace(cfg, reg_noise_std=0.0),
                init=init, device="cpu")
    # the noise is gone (std * 0.0 ** 1) from step 2 on, and steps 0, 1 differ
    assert not torch.equal(runs[0].losses[:2], quiet.losses[:2])
    final, best = runs[0].params, runs[0].best_params
    assert final.keys() == best.keys() and any(not torch.equal(best[k], final[k]) for k in final)


def test_find_best_update_keeps_only_real_improvements():
    """The 1.005 rule on a hand-made loss sequence, against the JAX function."""
    sequence = [1.0, 0.999, 0.99, 0.9895, 0.98, 0.9799, 0.5]
    best_j = (jnp.asarray(jnp.inf), {"w": jnp.asarray(-1.0)})
    best_t = (torch.tensor(float("inf")), {"w": torch.tensor(-1.0)})
    kept = []
    for i, loss in enumerate(sequence):
        best_j = jfit.find_best_update(jnp.asarray(loss), *best_j, {"w": jnp.asarray(float(i))})
        best_t = find_best_update(torch.tensor(loss), *best_t, {"w": torch.tensor(float(i))})
        assert float(best_t[0]) == float(best_j[0]) and float(best_t[1]["w"]) == float(best_j[1]["w"])
        kept.append(int(best_t[1]["w"]))
    assert kept == [0, 0, 2, 2, 4, 4, 6]


@pytest.mark.parametrize("spatial,depth,method,noise_type", [
    ((16, 16), 8, "noise", "u"), ((4, 8, 8), 1, "noise", "n"), ((8, 6), 2, "meshgrid", "u"),
])
def test_get_noise_shapes_and_meshgrid(spatial, depth, method, noise_type):
    g = torch.Generator().manual_seed(0)
    ours = get_noise(g, depth, spatial, method=method, noise_type=noise_type)
    ref = np.asarray(j_get_noise(jax.random.PRNGKey(0), depth, spatial, method=method, noise_type=noise_type))
    assert ours.shape == ref.shape == (1, *spatial, depth) and ours.dtype == torch.float32
    if method == "meshgrid":
        np.testing.assert_array_equal(ours.numpy(), ref)
    elif noise_type == "u":
        assert 0.0 <= float(ours.min()) and float(ours.max()) <= 0.1 + 1e-6
    with pytest.raises(ValueError):
        get_noise(g, 3, (4, 4), method="meshgrid")


class _JLinear(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(3)(x)


def test_lbfgs_reaches_the_least_squares_minimum_as_jax_does():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 6, 6, 4)).astype(np.float32)
    A = rng.standard_normal((4, 3)).astype(np.float32)
    y = (x @ A + 0.1 * rng.standard_normal((1, 6, 6, 3))).astype(np.float32)
    X1 = np.concatenate([x.reshape(-1, 4), np.ones((36, 1), np.float32)], axis=1).astype(np.float64)
    coef = np.linalg.lstsq(X1, y.reshape(-1, 3).astype(np.float64), rcond=None)[0]
    floor = float(np.mean((X1 @ coef - y.reshape(-1, 3)) ** 2))
    cfg = dict(num_iter=20, optimizer="lbfgs")
    key = jax.random.PRNGKey(0)
    j_res = jfit.fit(_JLinear(), key, jnp.asarray(x), jnp.asarray(y), config=jfit.FitConfig(**cfg))
    params = _JLinear().init(jax.random.split(key)[0], jnp.asarray(x))["params"]["Dense_0"]
    init = {"weight": torch.tensor(np.asarray(params["kernel"]).T), "bias": torch.tensor(np.asarray(params["bias"]))}
    t_res = fit(torch.nn.Linear(4, 3), None, x, y, config=FitConfig(**cfg), init=init, device="cpu")
    t_final, j_final = float(t_res.losses[-1]), float(j_res.losses[-1])
    assert abs(t_final - floor) < 1e-5 and abs(j_final - floor) < 1e-5
    assert abs(t_final - j_final) < 1e-5
    assert float(t_res.losses[0]) == pytest.approx(float(j_res.losses[0]), rel=1e-5)


def test_get_dip_out_matches_jax(problem):
    """The one-shot DIP fit: 6 iterations of Adam at lr 0.01 on the masked
    loss, from the JAX fit's init."""
    x, y, mask, fnet, key, _ = problem
    init = _transplant(jax.jit(fnet.init)(key, jnp.asarray(x))["params"])
    kw = dict(num_iter=6, learning_rate=0.01)
    ref = jdip.get_dip_out(fnet, key, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), **kw)
    ours = get_dip_out(ConvNet(), None, x, y, mask, init=init, device="cpu", **kw)
    assert ours.n_iters == int(ref.n_iters) == 6 and ours.stopped == bool(ref.stopped)
    np.testing.assert_allclose(float(ours.loss), float(ref.loss), rtol=1e-4)
    out = np.asarray(ref.out)
    np.testing.assert_allclose(ours.out.numpy(), out, rtol=1e-4, atol=1e-4 * np.abs(out).max())
