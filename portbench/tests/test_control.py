"""On the card: the control (the reference in TF32 put in the program's
place; for ``dip_fast.cube36`` the bf16 reference with fp8 operands) fails
the cell's limits and the program passes them, at a size a test run holds.
The readings at the cells' own sizes, over a dozen seeds, come from
``control.py`` and are in PERF.md."""

import gc

import pytest
import torch

import run

pytestmark = pytest.mark.cuda

CELLS = {
    "dip.cube36": {"cell": {"pool": 1, "steps_per_solve": 5, "checked_steps": 5}},
    "lrs_pnp.scene144": {"cell": {"height": 72, "width": 72, "pool": 1}},
    "dip_fast.cube36": {"cell": {"pool": 1, "steps_per_solve": 3, "checked_steps": 3}},
}


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("seed", [7, 2**31 + 11, 123456789])
def test_control_fails_and_program_passes(workload, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, ctx, driver = run.build(workload, seed, "cuda", CELLS[workload])
    driver.setup()
    records, failed, _ = run.window(driver, 0.1)
    driver.release()
    gc.collect()
    limits = ctx.cell["limits"]
    program = driver.readings()
    control = driver.readings(control=True)
    assert records and not failed
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control
