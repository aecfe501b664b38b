"""The port's early stop and DIP fit against the JAX package.

The early-stop state machine is compared exactly on numpy-made output
trajectories.  The DIP fit starts both sides from the same flax init,
carried over by ``skip_params_from_flax``; outputs and loss within rtol
1e-3 / atol 1e-5 (Adam at lr 0.1 amplifies the f32 ordering differences
of the convolutions over the iterations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.models import Skip as JSkip
from lrs_pnp_dip_tpu.solvers import dip as jdip
from lrs_pnp_dip_tpu.solvers import early_stop as jes
from lrs_pnp_dip_tpu_torch.models import Skip, skip_params_from_flax
from lrs_pnp_dip_tpu_torch.solvers import dip as tdip
from lrs_pnp_dip_tpu_torch.solvers import early_stop as tes
from lrs_pnp_dip_tpu_torch.utils.config import DipConfig

NET = dict(
    num_output_channels=8,
    channels_down=(8, 8),
    channels_up=(8, 8),
    channels_skip=(4, 4),
    pad="reflection",
)


def _trajectory(kind, n, dim, rng):
    base = rng.random(dim).astype(np.float32)
    if kind == "shrinking":  # variance falls, then flattens
        return [base + rng.normal(0, 0.5 / (1 + i), dim).astype(np.float32) for i in range(n)]
    if kind == "u_shaped":  # variance falls, then rises again
        return [
            base + rng.normal(0, 0.05 + 0.02 * abs(i - n / 3), dim).astype(np.float32)
            for i in range(n)
        ]
    return [base.copy() for _ in range(n)]  # constant: variance exactly 0


@pytest.mark.parametrize("kind", ["shrinking", "u_shaped", "constant"])
def test_early_stop_matches_state_machine(kind):
    rng = np.random.default_rng(11)
    size, dim, patience = 6, 20, 5
    es_j = jes.init_early_stop(size, dim)
    es_t = tes.init_early_stop(size, dim)
    stop_t = stop_j = None
    for i, row in enumerate(_trajectory(kind, 60, dim, rng)):
        es_j = jes.update_early_stop(es_j, jnp.asarray(row), i, patience)
        tes.update_early_stop(es_t, torch.from_numpy(row), i, patience)
        assert es_t.count == int(es_j.count)
        assert es_t.wait == int(es_j.wait)
        assert es_t.best_iter == int(es_j.best_iter)
        assert es_t.stop == bool(es_j.stop)
        if es_t.best_score != np.inf:
            np.testing.assert_allclose(
                es_t.best_score, float(es_j.best_score), rtol=1e-5, atol=1e-12
            )
        if es_t.stop and stop_t is None:
            stop_t = i
        if bool(es_j.stop) and stop_j is None:
            stop_j = i
    assert stop_t == stop_j
    assert stop_t is not None


@pytest.mark.parametrize(
    "cfg,stops",
    [
        # runs to the cap; returns the mean of the last 4 outputs
        (DipConfig(num_iter=6, buffer_size=4, return_mode="window_mean"), False),
        # the early stop fires; returns the last output
        (DipConfig(num_iter=40, buffer_size=3, patience=2, learning_rate=0.01), True),
    ],
    ids=["fixed_iters_window_mean", "early_stop_last"],
)
def test_dip_fit_matches_with_transplanted_init(cfg, stops):
    rng = np.random.default_rng(5)
    dip_input = rng.random((1, 12, 12, 8), dtype=np.float32)
    target = rng.random((1, 12, 12, 8), dtype=np.float32)
    mask = (rng.random((1, 12, 12, 1)) > 0.15).astype(np.float32)

    fnet = JSkip(**NET)
    key = jax.random.PRNGKey(7)
    params = jax.tree.map(
        np.asarray, jax.jit(fnet.init)(key, jnp.asarray(dip_input))["params"]
    )
    ref = jax.jit(jdip.make_dip_fit(fnet, jdip.DipConfig(**cfg.__dict__)))(
        key, jnp.asarray(dip_input), jnp.asarray(target), jnp.asarray(mask)
    )

    tnet = Skip(num_input_channels=8, **NET)
    res = tdip.make_dip_fit(tnet, cfg)(
        torch.from_numpy(dip_input), torch.from_numpy(target), torch.from_numpy(mask),
        init=skip_params_from_flax(params),
    )
    assert res.n_iters == int(ref.n_iters)
    assert res.stopped == bool(ref.stopped) == stops
    np.testing.assert_allclose(float(res.loss), float(ref.loss), rtol=1e-3)
    np.testing.assert_allclose(res.out.numpy(), np.asarray(ref.out), rtol=1e-3, atol=1e-5)


def test_dip_fit_reinitialises_from_generator():
    """Without ``init`` each fit re-draws the net from the generator: the
    same seed gives the same result, another draw a different one."""
    rng = np.random.default_rng(6)
    x, t = (torch.from_numpy(rng.random((1, 12, 12, 8), dtype=np.float32)) for _ in range(2))
    m = torch.ones((1, 12, 12, 1))
    fit = tdip.make_dip_fit(Skip(num_input_channels=8, **NET), DipConfig(num_iter=3))
    gen = torch.Generator().manual_seed(0)
    a = fit(x, t, m, generator=gen).out
    b = fit(x, t, m, generator=gen).out
    c = fit(x, t, m, generator=torch.Generator().manual_seed(0)).out
    assert torch.equal(a, c) and not torch.equal(a, b)


@pytest.mark.parametrize(
    "cfg", [DipConfig(es_mode="incremental"), DipConfig(compute_dtype="bfloat16")]
)
def test_unported_dip_options_raise(cfg):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdip.make_dip_fit(Skip(num_input_channels=8, **NET), cfg)
