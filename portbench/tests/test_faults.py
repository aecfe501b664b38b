"""A whole run at a tiny size on the CPU, past the harness's look for a
card, with the timed path sound and then broken underneath
(``portbench/faults.py``): ``correct`` holds for the sound run and comes
out false for each fault the cell can have (a step that returns its state
unchanged; a DIP fit that leaves its net unchanged, stops after one chunk,
or returns its last output where the configuration asks for its window's
mean; half of a batch left out; an answer altered where it is produced).
One card, so no exchange between cards to leave out."""

import pytest
import torch

import run
from faults import FAULTS

torch.set_num_threads(2)

SMALL = {"problem": {"bands": 36}, "solver": {"sparse": {"n_iter": 5}}}
CELLS = {
    "dip.cube36": {**SMALL, "cell": {"pool": 2, "steps_per_solve": 2, "checked_steps": 2, "trace_steps": 1},
                   "solver": {"sparse": {"n_iter": 5}, "dip": {"num_iter": 400, "buffer_size": 10, "patience": 10}}},
    "lrs_pnp.scene144": {**SMALL, "cell": {"height": 72, "width": 72, "pool": 1, "trace_requests": 1}},
    "dip_fast.cube36": {**SMALL, "cell": {"pool": 1, "steps_per_solve": 2, "checked_steps": 2, "trace_steps": 1},
                        "solver": {"sparse": {"n_iter": 5}, "dip": {"num_iter": 60, "buffer_size": 5, "patience": 5}}},
}
CASES = [
    ("dip.cube36", None), ("dip.cube36", "unchanged_state"), ("dip.cube36", "altered_state"),
    ("dip.cube36", "frozen_fit"), ("dip.cube36", "cut_fit"),
    ("lrs_pnp.scene144", None), ("lrs_pnp.scene144", "unchanged_state"), ("lrs_pnp.scene144", "half_batch"),
    ("lrs_pnp.scene144", "altered_scene"),
    ("dip_fast.cube36", None), ("dip_fast.cube36", "unchanged_state"), ("dip_fast.cube36", "altered_state"),
    ("dip_fast.cube36", "frozen_fit"), ("dip_fast.cube36", "cut_fit"), ("dip_fast.cube36", "window_last"),
]


@pytest.mark.parametrize("workload,fault", CASES, ids=[f"{w}-{f or 'sound'}" for w, f in CASES])
def test_correct_sees_each_fault(workload, fault, monkeypatch):
    if fault is not None:
        FAULTS[fault](monkeypatch.setattr)
    result, compared = run.execute(workload, 2**31 + 5, 0.5, False, device="cpu", overrides=CELLS[workload])
    assert result["attempted"] >= 1 and list(result)[-1] == "compared"
    if fault is None:
        assert result["correct"] and result["failed"] == 0, compared
    else:
        assert not result["correct"], compared
