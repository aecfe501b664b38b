"""The plain reference runs at a tiny size on the CPU and agrees with the
program there, stage by stage."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import program  # noqa: F401  (puts the port on the path)
from reference import skip128
from reference import solver as ref
from yardstick import inputs

torch.set_num_threads(2)

HERE = Path(__file__).resolve().parents[1]


def _setup(**kw):
    base = dict(variant="lrs_pnp", gamma=0.5, mu1=0.15, mu2=0.9, block_size=4, stride=4, lambda_ista=0.1,
                n_iter=6, alpha_mode="specnorm", h_scale=0.1, power_iters=10)
    base.update(kw)
    return ref.Setup(**base)


def _problem(seed=3, h=8, w=8, b=10):
    noisy, mask, clean = inputs.synthetic_sample(h, w, b, seed=seed)
    D = np.random.default_rng(seed).standard_normal((16, 24)).astype(np.float32)
    D /= np.linalg.norm(D, axis=0, keepdims=True)
    return noisy, mask, clean, D


def test_blocks_follow_the_append_rule_and_scatter_is_the_adjoint():
    g = ref.grid(64, 10, 4, 4)
    assert g.band_starts == (0, 4, 6)
    Z = torch.randn(64, 10)
    B = ref.extract(Z, g)
    assert B.shape == (16 * 3, 16)
    V = torch.randn_like(B)
    assert torch.allclose((B * V).sum(), (Z * ref.scatter(V, g)).sum(), rtol=1e-5)


def test_nlm_matches_the_ports_on_random_rows():
    from lrs_pnp_dip_tpu_torch.ops.nlm import nlm_column_batch_fast

    G = torch.randn(7, 40)
    h = torch.rand(7) * 0.5 + 0.05
    assert torch.allclose(ref.nlm_fast_1d(G, h), nlm_column_batch_fast(G, h), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("alpha_mode", ["trace4", "specnorm"])
def test_lrs_pnp_solve_matches_the_program(alpha_mode):
    noisy, mask, _, D = _problem()
    s = _setup(alpha_mode=alpha_mode)
    cfg = program.preset("lrs_pnp", block_size=4, stride=4, mu2=0.9)
    cfg = cfg.__class__(**{**cfg.__dict__, "sparse": cfg.sparse.__class__(
        **{**cfg.sparse.__dict__, "n_iter": 6, "alpha_mode": alpha_mode, "power_iters": 10})})
    got, _ = program.inpaint(noisy, mask, config=cfg, dictionary=D, device="cpu")
    want = ref.solve(noisy, mask, D, s, 2, "cpu").numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_scene_reference_stitches_tiles_solved_alone():
    noisy, mask, _, D = _problem(h=16, w=12)
    s = _setup()
    scene = ref.solve_scene(noisy, mask, D, s, 1, (8, 8), "cpu")
    right = ref.solve(noisy[8:16, 4:12], mask[8:16, 4:12], D, s, 1, "cpu").numpy()  # the last column pulled in
    left = ref.solve(noisy[8:16, 0:8], mask[8:16, 0:8], D, s, 1, "cpu").numpy()
    np.testing.assert_array_equal(scene[8:16, 8:12], right[:, 4:8])
    np.testing.assert_allclose(scene[8:16, 4:8], (left[:, 4:8] + right[:, 0:4]) / 2, rtol=1e-6)
    assert scene.shape == noisy.shape and np.isfinite(scene).all()


def test_dip_fit_starts_at_the_nets_output_and_stops_by_the_window():
    noisy, mask, _, _ = _problem(h=36, w=36, b=4)
    params = skip128.init_params(skip128.param_spec(4, width=8), torch.Generator().manual_seed(0), "cpu")
    s = _setup(variant="dip", dip_num_iter=50, dip_lr=0.01, dip_window=3, dip_patience=2)
    z = torch.rand(4, 36, 36)
    y = torch.as_tensor(noisy).permute(2, 0, 1)
    m = torch.as_tensor(mask)
    first = ref.dip_fit(params, z, y, m, s, n_iters=1)
    fit = ref.dip_fit(params, z, y, m, s)
    torch.testing.assert_close(first.out, skip128.forward(params, z[None])[0])
    assert first.n_iters == 1 and 3 <= fit.n_iters <= 50


def test_dip_step_matches_the_program_given_its_dip_output():
    noisy, mask, _, _ = _problem(h=36, w=36, b=36)
    config = json.loads((HERE / "configs" / "dip.json").read_text())
    D = inputs.load_dictionary(HERE.parent / config["problem"]["dictionary"])
    cfg = program.preset("dip", outer_iters=2)
    cfg = cfg.__class__(**{**cfg.__dict__,
                           "sparse": cfg.sparse.__class__(**{**cfg.sparse.__dict__, "n_iter": 4}),
                           "dip": cfg.dip.__class__(**{**cfg.dip.__dict__, "num_iter": 3})})
    spec = skip128.param_spec(36)
    inits = [skip128.init_params(spec, torch.Generator().manual_seed(k), "cpu") for k in range(2)]
    solver = program.Solver(program.HsiSample(noisy=noisy, mask=mask), D, cfg, device="cpu",
                            dip_init=lambda itr: inits[itr])
    chain = []
    solver.run(callback=lambda i, st, aux: chain.append((st.X, st.lambda1, st.lambda2, aux.U)))
    s = _setup(variant="dip", mu1=0.1, mu2=0.1, block_size=36, stride=36, n_iter=4, alpha_mode="trace4",
               h_scale=1.0, dip_num_iter=3, dip_lr=0.1, dip_window=30, dip_patience=60)
    pr = ref.problem(noisy, mask, D, s, "cpu")
    start = ref.initial_state(pr)
    for X, l1, l2, U in chain:
        want = ref.step(start, pr, s, U=U).state
        for a, b in zip((X, l1, l2), want):
            assert float((a - b).abs().max() / b.abs().max()) < 1e-5
        start = ref.State(X, l1, l2)
