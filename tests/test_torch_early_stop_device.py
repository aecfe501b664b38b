"""The port's early stop as a state machine of tensors, against the JAX
package's ``update_early_stop``.

Both evaluators are pushed the same numpy-made output rows, the JAX tests'
trajectories among them (``tests/test_dip.py``: shrinking perturbations
through several ring wraps and resyncs, and the cancellation case of mean ~1
and variance ~1e-7).  After every push ``count``, ``best_iter``, ``wait``
and ``stop`` are equal exactly; ``best_score`` within rtol 1e-5 in the exact
mode and 1e-4 in the incremental one, whose running sums are summed in
another order than XLA's (rtol 1e-4, atol 8 * size * eps32 times the scale
of their terms, which cancel to near zero about the origin); the origin, a mean of the window's rows
of order 1, within rtol 1e-6 / atol 1e-7 (a few f32 ulps of the rows).  Every field stays a tensor, the update
reads nothing back to the host, and a push with ``enabled`` false leaves
every field exactly as it was."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from lrs_pnp_dip_tpu.solvers import early_stop as jes
from lrs_pnp_dip_tpu_torch.solvers import early_stop as tes

# One intra-op thread: the suite runs in several worker processes, and torch's
# default of a thread per core in each of them oversubscribes the cores
# and multiplies the suite's wall time.
torch.set_num_threads(1)

HOST_READS = {"__float__", "__int__", "__bool__", "__index__", "item", "tolist", "numpy"}


class CountHostReads(TorchFunctionMode):
    """Counts the calls that bring a tensor's value to the host."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in HOST_READS:
            self.reads.append(func.__name__)
        return func(*args, **(kwargs or {}))


def _rows(kind, n, dim, seed):
    rng = np.random.default_rng(seed)
    if kind == "tiny_variance":  # tests/test_dip.py:75: mean ~1, variance ~1e-7
        base = (1.0 + 0.1 * rng.random(dim)).astype(np.float32)
        return [base + rng.normal(0, 3.2e-4, dim).astype(np.float32) for _ in range(n)]
    base = rng.random(dim).astype(np.float32)
    if kind == "shrinking":  # tests/test_dip.py:46, through the ring wraps and resyncs
        return [base + rng.normal(0, 0.5 / (1 + i), dim).astype(np.float32) for i in range(n)]
    if kind == "u_shaped":
        return [base + rng.normal(0, 0.05 + 0.02 * abs(i - n / 3), dim).astype(np.float32) for i in range(n)]
    return [base.copy() for _ in range(n)]  # constant: variance exactly 0


@pytest.mark.parametrize("tensor_iter", [False, True], ids=["int_iter", "tensor_iter"])
@pytest.mark.parametrize("incremental", [False, True], ids=["exact", "incremental"])
@pytest.mark.parametrize("kind,size,dim,n,patience", [
    ("shrinking", 6, 32, 20, 4),
    ("u_shaped", 6, 20, 60, 5),
    ("constant", 5, 8, 16, 3),
    ("tiny_variance", 8, 64, 27, 4),
])
def test_device_early_stop_matches_jax_after_every_push(kind, size, dim, n, patience, incremental, tensor_iter):
    es_j = jes.init_early_stop(size, dim, incremental=incremental)
    es_t = tes.init_early_stop(size, dim, incremental=incremental)
    rtol = 1e-4 if incremental else 1e-5
    for i, row in enumerate(_rows(kind, n, dim, seed=size + dim)):
        es_j = jes.update_early_stop(es_j, jnp.asarray(row), i, patience)
        cur = torch.tensor(i) if tensor_iter else i
        with CountHostReads() as mode:
            tes.update_early_stop(es_t, torch.from_numpy(row), cur, patience)
        assert mode.reads == []
        for name in ("count", "best_iter", "wait", "stop", "best_score"):
            assert isinstance(getattr(es_t, name), torch.Tensor) and getattr(es_t, name).ndim == 0
        assert int(es_t.count) == int(es_j.count)
        assert int(es_t.best_iter) == int(es_j.best_iter)
        assert int(es_t.wait) == int(es_j.wait)
        assert bool(es_t.stop) == bool(es_j.stop)
        np.testing.assert_allclose(float(es_t.best_score), float(es_j.best_score), rtol=rtol, atol=1e-12)
        if incremental:
            # a running sum of `size` terms in another order: a few f32 ulps of its terms' scale
            term = float(np.abs(np.asarray(es_j.window) - np.asarray(es_j.origin)).max())
            ulps = 8 * size * np.finfo(np.float32).eps
            np.testing.assert_allclose(es_t.sum.numpy(), np.asarray(es_j.sum), rtol=1e-4, atol=ulps * term)
            np.testing.assert_allclose(es_t.sumsq.numpy(), np.asarray(es_j.sumsq), rtol=1e-4, atol=ulps * term**2)
            np.testing.assert_allclose(es_t.origin.numpy(), np.asarray(es_j.origin), rtol=1e-6, atol=1e-7)
    if kind in ("u_shaped", "constant"):
        assert bool(es_t.stop)  # a variance that stops falling fires the stop


@pytest.mark.parametrize("incremental", [False, True], ids=["exact", "incremental"])
def test_disabled_pushes_leave_the_state_exactly(incremental):
    """Pushes with ``enabled`` false between the real ones change nothing:
    the state equals, field by field and bit for bit, that of a machine
    that only saw the real pushes."""
    size, dim = 4, 16
    rows = _rows("shrinking", 14, dim, seed=3)
    noise = _rows("u_shaped", 14, dim, seed=4)
    es_ref = tes.init_early_stop(size, dim, incremental=incremental)
    es = tes.init_early_stop(size, dim, incremental=incremental)
    on, off = torch.tensor(True), torch.tensor(False)
    for i, (row, junk) in enumerate(zip(rows, noise)):
        tes.update_early_stop(es_ref, torch.from_numpy(row), i, 3)
        tes.update_early_stop(es, torch.from_numpy(junk), 100 + i, 3, enabled=off)
        tes.update_early_stop(es, torch.from_numpy(row), torch.tensor(i), 3, enabled=on)
        tes.update_early_stop(es, torch.from_numpy(junk), 200 + i, 3, enabled=off)
        for name in ("window", "count", "best_score", "best_iter", "wait", "stop", "sum", "sumsq", "origin"):
            ours, ref = getattr(es, name), getattr(es_ref, name)
            assert (ours is None and ref is None) or torch.equal(ours, ref), name


def test_reset_returns_the_initial_state_in_place():
    es = tes.init_early_stop(3, 8, incremental=True)
    tensors = [es.window, es.count, es.best_score, es.sum]
    for i, row in enumerate(_rows("shrinking", 9, 8, seed=1)):
        tes.update_early_stop(es, torch.from_numpy(row), i, 2)
    tes.reset_early_stop(es)
    fresh = tes.init_early_stop(3, 8, incremental=True)
    for name in ("window", "count", "best_score", "best_iter", "wait", "stop", "sum", "sumsq", "origin"):
        assert torch.equal(getattr(es, name), getattr(fresh, name)), name
    assert [es.window, es.count, es.best_score, es.sum] == tensors  # the same storage, which a graph holds
