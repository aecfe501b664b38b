"""The port's multi-process dryrun through its launcher, on the CPU.

``python -m lrs_pnp_dip_tpu_torch.parallel.launch --nproc 2 --device cpu``
starts two ranks over gloo, which build one {patch: 1, band: 2} mesh
(``default_axes(2)``) and run one band-sharded `lrs_pnp` step at the
reference geometry (36x36x128, 36x36 blocks, a random K-128 dictionary, 4
ISTA iterations), held to a one-rank step at 5e-4.  The same step is held
here to the JAX package's local ``Solver`` step on the same inputs, at the
same 5e-4 (``lrs_pnp_dip_tpu/parallel/distributed.py:130``).
"""

import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from lrs_pnp_dip_tpu.data import random_dictionary as j_random_dictionary
from lrs_pnp_dip_tpu.data.masks import synthetic_sample as j_synthetic_sample
from lrs_pnp_dip_tpu.ops.ista import SparseProxConfig as JSparse
from lrs_pnp_dip_tpu.solvers import Solver as JSolver
from lrs_pnp_dip_tpu.utils.config import SolverConfig as JSolverConfig
from lrs_pnp_dip_tpu_torch.parallel import distributed
from lrs_pnp_dip_tpu_torch.parallel.launch import spawn
from lrs_pnp_dip_tpu_torch.parallel.workers import run_cases

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_launcher_runs_the_two_rank_dryrun():
    out = subprocess.run(
        [sys.executable, "-m", "lrs_pnp_dip_tpu_torch.parallel.launch", "--nproc", "2",
         "--device", "cpu", "--timeout", "120"],
        capture_output=True, text=True, timeout=240, cwd=_REPO,
        env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    assert "multiprocess_dryrun ok: processes=2, device=cpu" in out.stdout
    assert "mesh={'patch': 1, 'band': 2}" in out.stdout
    diff = float(re.search(r"max\|X_sharded-X_local\|=(\S+)", out.stdout).group(1))
    assert diff < 5e-4


def test_dryrun_step_matches_jax_local_step(tmp_path):
    res = spawn(run_cases, 2, args=("cpu", [("dryrun_case", {})]),
                init_method=f"file://{tmp_path / 'store'}")
    X = res[0][0]["X"]
    np.testing.assert_array_equal(res[1][0]["X"], X)
    sample, _, _ = distributed.dryrun_problem()
    j_sample = j_synthetic_sample(height=36, width=36, bands=128, missing=0.1, seed=0)
    np.testing.assert_array_equal(sample.noisy, j_sample.noisy)
    cfg = JSolverConfig(variant="lrs_pnp", outer_iters=1, block_size=36, stride=36,
                        sparse=JSparse(n_iter=4, backend="xla"), dip=None)
    solver = JSolver(j_sample, j_random_dictionary(36 * 36, 128, seed=0), cfg)
    st, _ = solver.step(solver.init_state())
    assert X.shape == (36 * 36, 128) and np.isfinite(X).all()
    assert float(np.max(np.abs(X - np.asarray(st.X)))) < 5e-4


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.is_primary()
    assert distributed.default_axes(4) == {"patch": 2, "band": 2}
    assert distributed.default_axes(3) == {"patch": 3}


def test_spawn_stops_ranks_past_their_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 3"):
        spawn(time.sleep, 2, args=(60,), timeout_s=3)
    assert time.monotonic() - t0 < 30
