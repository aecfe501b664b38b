"""The port's early stop and DIP fit against the JAX package.

The early-stop state machine is compared exactly, in both evaluators, on
numpy-made output trajectories (those of ``tests/test_dip.py`` among them).
The DIP fit starts both sides from the same flax init, carried over by
``skip_params_from_flax``; outputs and loss within rtol 1e-3 / atol 1e-5
(Adam at lr 0.1 amplifies the f32 ordering differences of the convolutions
over the iterations).  With ``compute_dtype='bfloat16'`` only the first
forward compares value for value, within 2e-2 of max |out| (bf16 has 8 bits
of mantissa, and the two frameworks round inside batch norm at other
places)."""

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
from lrs_pnp_dip_tpu_torch.data import synthetic_sample
from lrs_pnp_dip_tpu_torch.solvers import OuterStages, Solver, init_state, make_consts
from lrs_pnp_dip_tpu_torch.utils import config as tconfig
from lrs_pnp_dip_tpu_torch.utils.config import DipConfig

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

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


@pytest.mark.parametrize("incremental", [False, True], ids=["exact", "incremental"])
@pytest.mark.parametrize("kind", ["shrinking", "u_shaped", "constant"])
def test_early_stop_matches_state_machine(kind, incremental):
    rng = np.random.default_rng(11)
    size, dim, patience = 6, 20, 5
    es_j = jes.init_early_stop(size, dim, incremental=incremental)
    es_t = tes.init_early_stop(size, dim, incremental=incremental)
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
    "seed,size,dim,n,sigma",
    [
        (0, 6, 32, 20, None),  # shrinking perturbations, through 3 ring wraps and resyncs
        (7, 8, 64, 27, 3.2e-4),  # mean ~1, variance ~1e-7: where a sum about 0 cancels
    ],
    ids=["shrinking", "tiny_variance"],
)
def test_incremental_early_stop_on_the_jax_tests_trajectories(seed, size, dim, n, sigma):
    """The trajectories of ``tests/test_dip.py``: the incremental evaluator
    makes the JAX state machine's decisions at every push (stop, best_iter,
    wait), keeps its running sums, and tracks the port's exact evaluator."""
    rng = np.random.default_rng(seed)
    base = rng.random(dim).astype(np.float32) if sigma is None else (
        1.0 + 0.1 * rng.random(dim)).astype(np.float32)
    es_j = jes.init_early_stop(size, dim, incremental=True)
    es_t = tes.init_early_stop(size, dim, incremental=True)
    es_e = tes.init_early_stop(size, dim)
    for i in range(n):
        row = base + rng.normal(0, sigma or 0.5 / (1 + i), dim).astype(np.float32)
        es_j = jes.update_early_stop(es_j, jnp.asarray(row), i, 4)
        tes.update_early_stop(es_t, torch.from_numpy(row), i, 4)
        tes.update_early_stop(es_e, torch.from_numpy(row), i, 4)
        assert (es_t.stop, es_t.best_iter, es_t.wait) == (
            bool(es_j.stop), int(es_j.best_iter), int(es_j.wait))
        assert (es_t.stop, es_t.best_iter, es_t.wait) == (es_e.stop, es_e.best_iter, es_e.wait)
        np.testing.assert_allclose(es_t.sum.numpy(), np.asarray(es_j.sum), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(es_t.sumsq.numpy(), np.asarray(es_j.sumsq), rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(es_t.origin.numpy(), np.asarray(es_j.origin), rtol=1e-6)
    assert es_t.count == n and es_t.best_score < np.inf
    np.testing.assert_allclose(es_t.best_score, float(es_j.best_score), rtol=1e-4)
    np.testing.assert_allclose(es_t.best_score, es_e.best_score, rtol=0.02)
    if sigma is not None:
        assert 1e-8 < es_e.best_score < 1e-6  # the targeted regime
    assert tes.init_early_stop(size, dim).sum is None  # exact mode carries no sums


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


def test_dip_fit_of_the_identity_net_runs():
    """``get_net(..., 'identity')`` has no parameters: the fit trains nothing,
    returns its input, and the early stop ends it on the constant output
    (variance 0 from the first full window: ``buffer_size`` pushes, then
    ``patience`` checks without improvement).  The JAX fit cannot take this
    net (flax gives it no ``params`` collection), so there is no reference."""
    from lrs_pnp_dip_tpu_torch.models import get_net

    rng = np.random.default_rng(8)
    x, t = (torch.from_numpy(rng.random((1, 6, 6, 4), dtype=np.float32)) for _ in range(2))
    m = torch.from_numpy((rng.random((1, 6, 6, 1)) > 0.2).astype(np.float32))
    res = tdip.make_dip_fit(get_net(4, "identity"), DipConfig(num_iter=30, buffer_size=3, patience=2))(
        x, t, m, generator=torch.Generator().manual_seed(0)
    )
    assert res.stopped and res.n_iters < 30
    assert torch.equal(res.out, x)
    np.testing.assert_allclose(float(res.loss), float(torch.mean((t * m - x * m) ** 2)), rtol=1e-6)


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


def test_incremental_early_stop_fires_in_fit():
    """es_mode='incremental' through make_dip_fit stops where 'exact' stops."""
    rng = np.random.default_rng(5)
    x, t = (torch.from_numpy(rng.random((1, 12, 12, 8), dtype=np.float32)) for _ in range(2))
    m = torch.ones((1, 12, 12, 1))
    net = Skip(num_input_channels=8, **NET)
    net.reset_parameters(torch.Generator().manual_seed(2))
    init = {k: v.clone() for k, v in net.state_dict().items()}
    res = {
        mode: tdip.make_dip_fit(net, DipConfig(
            num_iter=80, learning_rate=0.01, buffer_size=5, patience=3, es_mode=mode,
        ))(x, t, m, init=init)
        for mode in ("exact", "incremental")
    }
    assert res["incremental"].stopped and res["incremental"].n_iters < 80
    assert res["incremental"].n_iters == res["exact"].n_iters
    assert torch.equal(res["incremental"].out, res["exact"].out)


def test_bf16_dip_fit_first_iteration_matches_and_masters_stay_f32():
    rng = np.random.default_rng(8)
    dip_input = rng.random((1, 12, 12, 8), dtype=np.float32)
    target = rng.random((1, 12, 12, 8), dtype=np.float32)
    mask = (rng.random((1, 12, 12, 1)) > 0.15).astype(np.float32)
    cfg = dict(num_iter=1, compute_dtype="bfloat16")
    fnet = JSkip(**NET)
    key = jax.random.PRNGKey(7)
    params = jax.tree.map(np.asarray, jax.jit(fnet.init)(key, jnp.asarray(dip_input))["params"])
    ref = jax.jit(jdip.make_dip_fit(fnet, jdip.DipConfig(**cfg)))(
        key, jnp.asarray(dip_input), jnp.asarray(target), jnp.asarray(mask)
    )
    tnet = Skip(num_input_channels=8, **NET)
    args = (torch.from_numpy(dip_input), torch.from_numpy(target), torch.from_numpy(mask))
    res = tdip.make_dip_fit(tnet, DipConfig(**cfg))(*args, init=skip_params_from_flax(params))
    assert res.out.dtype == torch.float32 and res.loss.dtype == torch.float32
    ref_out = np.asarray(ref.out)
    np.testing.assert_allclose(res.out.numpy(), ref_out, rtol=0, atol=2e-2 * np.abs(ref_out).max())
    np.testing.assert_allclose(float(res.loss), float(ref.loss), rtol=2e-2)
    # the output went through bf16: it differs from the f32 fit's first forward
    f32 = tdip.make_dip_fit(tnet, DipConfig(num_iter=1))(*args, init=skip_params_from_flax(params))
    assert 0 < float((res.out - f32.out).abs().max()) < 0.1
    # masters and gradients stay f32, and one Adam step moved the masters
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in tnet.parameters())
    assert not torch.equal(tnet.Conv2d_0.weight.detach(), skip_params_from_flax(params)["Conv2d_0.weight"])
    # a longer bf16 fit still learns
    longer = tdip.make_dip_fit(tnet, DipConfig(num_iter=40, learning_rate=0.01, compute_dtype="bfloat16"))(
        *args, init=skip_params_from_flax(params))
    assert float(longer.loss) < 0.8 * float(res.loss)
    with pytest.raises(ValueError, match="compute_dtype"):
        tdip.make_dip_fit(tnet, DipConfig(compute_dtype="float16"))


def _small_problem():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((36, 48)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    return synthetic_sample(12, 12, 8, missing=0.1, seed=3), D


def test_noise_input_mode_draws_a_fresh_input_each_outer_step():
    """input_mode='noise': the DIP input is noise_var * U[0, 1) of the cube's
    shape, drawn from the state's generator at every outer step."""
    s, D = _small_problem()
    cfg = tconfig.SolverConfig(
        block_size=6, stride=6, sparse=tconfig.SparseProxConfig(n_iter=3),
        dip=DipConfig(num_iter=2, buffer_size=2, input_mode="noise", noise_var=0.25),
    )
    seen = []

    def run(seed):
        stages = OuterStages(cfg, s.shape, net=Skip(num_input_channels=8, **NET), device="cpu")
        fit = stages.dip_fit

        def recording_fit(dip_input, *args, **kw):
            seen.append(dip_input.clone())
            return fit(dip_input, *args, **kw)

        stages.dip_fit = recording_fit
        consts = make_consts(s, D, cfg, device="cpu")
        state = init_state(s, seed, device="cpu")
        for _ in range(2):
            U, n_iters, _ = stages.low_rank(state, consts)
            state = state._replace(itr=state.itr + 1)
        return U

    u_a, u_b, u_c = run(0), run(0), run(1)
    assert all(x.shape == (1, 12, 12, 8) for x in seen)
    assert all(0.0 <= float(x.min()) and float(x.max()) < 0.25 for x in seen)
    assert float(max(x.max() for x in seen)) > 0.2
    assert not torch.equal(seen[0], seen[1])  # a new draw each outer step
    assert torch.equal(seen[0], seen[2]) and torch.equal(seen[1], seen[3])  # same seed
    assert not torch.equal(seen[0], seen[4])  # another seed
    assert torch.equal(u_a, u_b) and not torch.equal(u_a, u_c)
    with pytest.raises(ValueError, match="input_mode"):
        OuterStages(
            tconfig.SolverConfig(block_size=6, stride=6, dip=DipConfig(input_mode="image")), s.shape,
            net=Skip(num_input_channels=8, **NET), device="cpu",
        )


def test_dip_fast_solve_is_finite():
    """The `dip_fast` preset's options together (bf16 sparse prox operands,
    bf16 DIP fit, incremental early stop, window-mean return), short."""
    s, D = _small_problem()
    fast = tconfig.dip_fast_preset(block_size=6, stride=6)
    cfg = tconfig.dataclasses.replace(
        fast, sparse=tconfig.dataclasses.replace(fast.sparse, n_iter=5),
        dip=tconfig.dataclasses.replace(fast.dip, num_iter=8, buffer_size=3, patience=2),
    )
    assert cfg.sparse.matmul_dtype == cfg.dip.compute_dtype == "bfloat16"
    assert cfg.dip.es_mode == "incremental" and cfg.dip.return_mode == "window_mean"
    solver = Solver(s, D, cfg, net=Skip(num_input_channels=8, **NET), device="cpu")
    state, hist = solver.run(2)
    assert np.isfinite(hist["mpsnr"]).all() and np.isfinite(solver.result_cube(state)).all()
    assert all(0 < n <= 8 for n in hist["dip_iters"])
