"""The port's `dip_fast` path against the benchmark's bfloat16 reference,
``portbench/reference/bf16.py``, on the CPU at a small size (the cell
``dip_fast.cube36`` runs end to end, sound and with each of its faults, in
``test_faults.py``).

Tolerances, each max|d|/max|ref| unless said:

* one bf16 forward of skip-128 at width 16 (a one-iteration fit's output,
  the mean of a window of one): 1e-6, measured 3.5e-8 (the program sums its
  window's ring of 30 rows and scales by 30, in float32);
* the plain ISTA loop with bf16 operands: equal bits (the same operations on
  the same operands in the same order); the float32 loop reads 2.7e-4 and the
  fp8 control 4.6e-3;
* a fit of 3 iterations at lr 1e-5: 0.03, measured 0.0125 to 0.0173 over
  four draws.  The forward agrees to rounding, but the backward does not
  (the program folds its reflection padding's gradient back in its own
  order), so Adam's first steps move a weight whose gradient is near zero
  by other amounts, and any change of a master weight can move its bf16
  copy by a whole bf16 step (2.4e-4 at 0.05, 24 times lr): the output
  moves 5 to 8% over the three iterations.  Returning the last output in
  place of the window's mean reads 0.046 to 0.141, so it fails;
* one outer step, the DIP output the same 0.03; the state given the
  program's DIP output 1e-5 (the same float32 arithmetic as the float32
  reference's, with the bf16 loop's equal bits).
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

import program
from reference import bf16, skip128
from reference import solver as ref
from yardstick import inputs

from lrs_pnp_dip_tpu_torch.models.skip import Skip
from lrs_pnp_dip_tpu_torch.ops.ista import pnp_ista_blocks
from lrs_pnp_dip_tpu_torch.solvers.dip import FIT_CHUNK, make_dip_fit
from lrs_pnp_dip_tpu_torch.utils.config import DipConfig, SparseProxConfig

torch.set_num_threads(2)

HERE = Path(__file__).resolve().parents[1]
FORWARD_TOL = 1e-6
FIT_TOL = 0.03
STATE_TOL = 1e-5


def _gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _net(bands, width):
    w = (width,) * 5
    return Skip(bands, bands, w, w, w, 3, 3, 1, True, "reflection", "nearest")


def _params(bands, width, seed):
    return skip128.init_params(skip128.param_spec(bands, width), torch.Generator().manual_seed(seed), "cpu")


def _fast(**dip):
    """The ``dip_fast`` preset with 4 ISTA iterations and ``dip`` over its fit."""
    cfg = program.preset("dip_fast", outer_iters=1)
    return dataclasses.replace(cfg, sparse=dataclasses.replace(cfg.sparse, n_iter=4),
                               dip=dataclasses.replace(cfg.dip, **dip))


def _fit(bands, width, seed, n_iters, lr, return_mode="window_mean"):
    noisy, mask, _ = inputs.synthetic_sample(36, 36, bands, seed=3)
    z = torch.rand((1, 36, 36, bands), generator=torch.Generator().manual_seed(10 + seed))
    y, m = torch.as_tensor(noisy)[None], torch.as_tensor(mask)[None, ..., None]
    p = _params(bands, width, seed)
    cfg = _fast(num_iter=n_iters, learning_rate=lr, return_mode=return_mode).dip
    got = make_dip_fit(_net(bands, width), cfg)(z, y, m, init=p, chunk=FIT_CHUNK)
    s = ref.Setup.from_config(dataclasses.asdict(_fast(num_iter=n_iters, learning_rate=lr)))
    args = (z[0].permute(2, 0, 1), y[0].permute(2, 0, 1), m[0, ..., 0], s)
    return got, args, p


@pytest.mark.parametrize("seed", [0, 1])
def test_one_bf16_forward_matches_the_reference(seed):
    got, args, p = _fit(8, 16, seed, 1, 0.1)
    want = bf16.forward(p, args[0][None])[0]
    assert got.n_iters == 1
    assert _gap(got.out[0].permute(2, 0, 1), want) < FORWARD_TOL
    assert _gap(bf16.forward(p, args[0][None], control=True)[0], want) > 100 * FORWARD_TOL
    assert _gap(skip128.forward(p, args[0][None])[0], want) > 100 * FORWARD_TOL  # f32 is another forward


def test_bf16_ista_matches_the_ports_plain_loop():
    D = torch.as_tensor(inputs.load_dictionary(HERE.parent / "artifacts" / "dictionary_36x36_k512.npz"))
    g = torch.Generator().manual_seed(0)
    Y = torch.rand((12, 1296), generator=g)
    M = (torch.rand((12, 1296), generator=g) > 0.05).float()
    alpha = ref.step_sizes(D, M, ref.Setup.from_config(dataclasses.asdict(_fast())))
    s = ref.Setup.from_config(dataclasses.asdict(_fast()))
    want = bf16.ista(Y, M, D, alpha, s)
    got = pnp_ista_blocks(Y, M, D, SparseProxConfig(n_iter=4, matmul_dtype="bfloat16"), alpha=alpha)
    f32 = pnp_ista_blocks(Y, M, D, SparseProxConfig(n_iter=4), alpha=alpha)
    assert torch.equal(got, want)
    assert _gap(f32, want) > 1e-5 and _gap(bf16.ista(Y, M, D, alpha, s, control=True), want) > 1e-4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_iteration_fit_matches_the_reference(seed):
    got, args, p = _fit(8, 16, seed, 3, 1e-5)
    want = bf16.dip_fit(p, *args, n_iters=3).out
    assert got.n_iters == 3
    assert _gap(got.out[0].permute(2, 0, 1), want) < FIT_TOL
    last, _, _ = _fit(8, 16, seed, 3, 1e-5, return_mode="last")
    assert _gap(last.out[0].permute(2, 0, 1), want) > FIT_TOL


def test_one_dip_fast_outer_step_matches_the_reference():
    noisy, mask, _ = inputs.synthetic_sample(36, 36, 36, seed=5)
    D = inputs.load_dictionary(HERE.parent / "artifacts" / "dictionary_36x36_k512.npz")
    cfg = _fast(num_iter=3, learning_rate=1e-5)
    init = _params(36, 16, 4)
    solver = program.Solver(program.HsiSample(noisy=noisy, mask=mask), D, cfg, net=_net(36, 16), device="cpu",
                            dip_init=lambda itr: init)
    state, aux = solver.step(solver.init_state())
    s = ref.Setup.from_config(dataclasses.asdict(cfg))
    pr = ref.problem(noisy, mask, D, s, "cpu")
    start = ref.initial_state(pr)
    fit = bf16.dip_prox(start, pr, s, init, dip_iters=aux.dip_iters)
    want = bf16.step(start, pr, s, U=aux.U).state
    assert aux.dip_iters == fit.n_iters == 3
    assert _gap(aux.U, fit.out) < FIT_TOL
    for got, w in zip((state.X, state.lambda1, state.lambda2), want):
        assert _gap(got, w) < STATE_TOL


def test_the_f32_reference_refuses_a_bf16_configuration():
    config = json.loads((HERE / "configs" / "dip_fast.json").read_text())
    s = ref.Setup.from_config(config["solver"])
    assert (s.matmul_dtype, s.dip_dtype, s.dip_return) == ("bfloat16", "bfloat16", "window_mean")
    assert ref.Setup.from_config(json.loads((HERE / "configs" / "dip.json").read_text())["solver"]).dip_return == "last"
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="float32 reference"):
        ref.ista(x, x, torch.zeros(4, 3), torch.ones(2), s)
    with pytest.raises(ValueError, match="float32 reference"):
        ref.solve(x, x, torch.zeros(4, 3), s, 1, "cpu")
    with pytest.raises(ValueError, match="nlm_fast"):
        ref.Setup.from_config({**config["solver"], "sparse": {**config["solver"]["sparse"], "denoiser": "nlm_classic"}})
    with pytest.raises(ValueError, match="checks every iteration"):
        ref.Setup.from_config({**config["solver"], "dip": {**config["solver"]["dip"], "show_every": 2}})
