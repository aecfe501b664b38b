"""The port's collectives and sharded sparse proxes against the JAX package.

The port's ranks are processes spawned through its launcher
(``lrs_pnp_dip_tpu_torch.parallel.launch.spawn``) on the CPU over gloo,
each rendezvousing through a file store under ``tmp_path``; every check that
shares a world size runs in one spawn (a module fixture).  The JAX
reference runs here, on the virtual CPU devices of ``tests/conftest.py``.

Tolerances: the SVTs at atol 2e-4 (``tests/test_parallel.py:39``); the 1-D
sparse prox equal bit for bit to the port's one-rank ``sparse_prox`` (each
rank codes its rows with the same loop, and the gathered coefficients are
reconstructed once) and within rtol 1e-4 / atol 1e-6 of
the JAX prox, Pallas in interpret mode and XLA (the ISTA twin's tolerance,
``tests/test_torch_ista.py``); the 2-D prox within atol 2e-5 / rtol 1e-5 of
the JAX 2-D prox and of the one-rank prox (``tests/test_parallel.py:223``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.ops.ista import SparseProxConfig as JSparse
from lrs_pnp_dip_tpu.ops.svt import svt_gram as j_svt_gram
from lrs_pnp_dip_tpu.parallel import (
    make_distributed_svt as j_make_svt,
    make_distributed_svt_2d as j_make_svt_2d,
    make_mesh as j_make_mesh,
    make_sharded_sparse_prox as j_make_prox,
    make_sharded_sparse_prox_2d as j_make_prox_2d,
)
from lrs_pnp_dip_tpu_torch.data import random_dictionary
from lrs_pnp_dip_tpu_torch.ops import ista as tista
from lrs_pnp_dip_tpu_torch.parallel.launch import spawn
from lrs_pnp_dip_tpu_torch.parallel.workers import run_cases
from lrs_pnp_dip_tpu_torch.utils.config import SparseProxConfig

torch.set_num_threads(1)

ALPHA_MODES = ("trace4", "specnorm")
SHAPES_2D = ((12, 64), (11, 60))  # divisible, padded on both axes
N_BLOCKS = (24, 13)  # divisible, one padding row over 2 ranks


def _svt_input():
    return np.random.default_rng(0).standard_normal((128, 16)).astype(np.float32)


def _prox_input(nB, P, K, dict_seed):
    rng = np.random.default_rng(nB * 1000 + P)
    mask = (rng.random((nB, P)) > 0.15).astype(np.float32)
    blocks = rng.standard_normal((nB, P)).astype(np.float32) * mask
    return blocks, mask, random_dictionary(P, K, seed=dict_seed)


def _cfg_2d(mode):
    return dict(n_iter=4, alpha_mode=mode, power_iters=12, backend="xla")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    cases = [("svt_case", dict(axis_sizes={"patch": 2}, X=_svt_input(), tau=0.5))]
    for nB in N_BLOCKS:
        blocks, mask, D = _prox_input(nB, 128, 64, 5)
        cases.append(("prox_case", dict(
            axis_sizes={"patch": 2}, blocks=blocks, mask=mask, D=D, cfg=SparseProxConfig(n_iter=4),
        )))
    store = tmp_path_factory.mktemp("two_ranks") / "store"
    return spawn(run_cases, 2, args=("cpu", cases), init_method=f"file://{store}")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    cases = [
        ("svt_case", dict(axis_sizes={"patch": 4}, X=_svt_input(), tau=0.5)),
        ("svt_case", dict(axis_sizes={"patch": 2, "band": 2}, X=_svt_input(), tau=0.5)),
    ]
    for mode in ALPHA_MODES:
        for nB, P in SHAPES_2D:
            blocks, mask, D = _prox_input(nB, P, 24, 3)
            cases.append(("prox_case", dict(
                axis_sizes={"patch": 2, "band": 2}, blocks=blocks, mask=mask, D=D,
                cfg=SparseProxConfig(**_cfg_2d(mode)),
            )))
    store = tmp_path_factory.mktemp("four_ranks") / "store"
    return spawn(run_cases, 4, args=("cpu", cases), init_method=f"file://{store}")


def _same_on_every_rank(results, pick):
    for r in results[1:]:
        np.testing.assert_array_equal(pick(r), pick(results[0]))
    return pick(results[0])


@pytest.mark.parametrize("n_patch", [2, 4])
def test_distributed_svt_matches_jax(two_ranks, four_ranks, n_patch):
    results = two_ranks if n_patch == 2 else four_ranks
    ours = _same_on_every_rank(results, lambda r: r[0][0])
    # the rank's piece through distributed_svt gives the drop-in's bits
    np.testing.assert_array_equal(_same_on_every_rank(results, lambda r: r[0][1]), ours)
    X = jnp.asarray(_svt_input())
    jmesh = j_make_mesh({"patch": n_patch}, devices=jax.devices()[:n_patch])
    np.testing.assert_allclose(ours, np.asarray(j_make_svt(jmesh, "patch")(X, 0.5)), atol=2e-4)
    np.testing.assert_allclose(ours, np.asarray(j_svt_gram(X, 0.5)), atol=2e-4)


def test_distributed_svt_2d_matches_jax(four_ranks):
    ours = _same_on_every_rank(four_ranks, lambda r: r[1][0])
    np.testing.assert_array_equal(_same_on_every_rank(four_ranks, lambda r: r[1][1]), ours)
    X = jnp.asarray(_svt_input())
    jmesh = j_make_mesh({"patch": 2, "band": 2}, devices=jax.devices()[:4])
    np.testing.assert_allclose(ours, np.asarray(j_make_svt_2d(jmesh, "patch", "band")(X, 0.5)), atol=2e-4)
    np.testing.assert_allclose(ours, np.asarray(j_svt_gram(X, 0.5)), atol=2e-4)


@pytest.mark.parametrize("index", range(len(N_BLOCKS)), ids=[f"nB{n}" for n in N_BLOCKS])
def test_sharded_sparse_prox_equal_bits_and_jax(two_ranks, index):
    """Each rank runs the loop on its half of the rows; on the CPU no kernel
    launches, and the result equals the one-rank prox bit for bit."""
    nB = N_BLOCKS[index]
    ours = _same_on_every_rank(two_ranks, lambda r: r[1 + index]["out"])
    assert all(r[1 + index]["launches"] == 0 for r in two_ranks)
    blocks, mask, D = _prox_input(nB, 128, 64, 5)
    one_rank = tista.sparse_prox(
        torch.from_numpy(blocks), torch.from_numpy(mask), torch.from_numpy(D), SparseProxConfig(n_iter=4)
    ).numpy()
    np.testing.assert_array_equal(ours, one_rank)
    jmesh = j_make_mesh({"patch": 2}, devices=jax.devices()[:2])
    for backend in ("pallas", "xla"):
        prox = jax.jit(j_make_prox(jmesh, JSparse(n_iter=4, backend=backend), "patch"))
        ref = np.asarray(prox(jnp.asarray(blocks), jnp.asarray(mask), jnp.asarray(D)))
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("alpha_mode", ALPHA_MODES)
@pytest.mark.parametrize("shape", SHAPES_2D)
def test_sharded_sparse_prox_2d_matches_jax_and_one_rank(four_ranks, alpha_mode, shape):
    index = 2 + ALPHA_MODES.index(alpha_mode) * len(SHAPES_2D) + SHAPES_2D.index(shape)
    ours = _same_on_every_rank(four_ranks, lambda r: r[index]["out"])
    assert all(r[index]["launches"] == 0 for r in four_ranks)
    blocks, mask, D = _prox_input(*shape, 24, 3)
    one_rank = tista.sparse_prox(
        torch.from_numpy(blocks), torch.from_numpy(mask), torch.from_numpy(D),
        SparseProxConfig(**_cfg_2d(alpha_mode)),
    ).numpy()
    np.testing.assert_allclose(ours, one_rank, atol=2e-5, rtol=1e-5)
    jmesh = j_make_mesh({"patch": 2, "band": 2}, devices=jax.devices()[:4])
    prox = j_make_prox_2d(jmesh, JSparse(**_cfg_2d(alpha_mode)), "patch", "band")
    ref = np.asarray(prox(jnp.asarray(blocks), jnp.asarray(mask), jnp.asarray(D)))
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-5)


def test_sharded_prox_bytes_moved(two_ranks):
    """Each rank receives the other rank's coefficients once: 12 rows of
    K = 64 f32 values at nB 24 (not the 128 values of a reconstructed row)."""
    assert [r[1]["bytes"] for r in two_ranks] == [12 * 64 * 4] * 2
