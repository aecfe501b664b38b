"""No module the benchmark loads is JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
GUARDED = {"jax", "jaxlib", "flax", "lrs_pnp_dip_tpu"}

LOAD_EVERYTHING = """
import json, sys
sys.path.insert(0, {here!r})
import run, control, program, faults
import reference.solver, reference.skip128, reference.lipschitz_unet, reference.bf16
import traffic.base, traffic.cube_steps, traffic.scene_stream, traffic.cube_steps_1lip, traffic.cube_steps_fast
import yardstick.inputs, yardstick.peaks, yardstick.b1, yardstick.flops, yardstick.trace
import yardstick.shares
bench = json.load(open({bench!r}))
for section in ("end_to_end", "per_layer"):
    for m in bench[section]:
        run.load_metric(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_nothing_loaded_is_jax_or_the_jax_package():
    code = LOAD_EVERYTHING.format(here=str(HERE), bench=str(HERE.parent / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=HERE.parent, timeout=300)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "lrs_pnp_dip_tpu_torch" in top  # the port is loaded, whole names compared
    assert not top & GUARDED, top & GUARDED


def test_run_refuses_a_process_that_loaded_jax_names():
    import run

    sys.modules.setdefault("lrs_pnp_dip_tpu", type(sys)("lrs_pnp_dip_tpu"))
    try:
        assert "lrs_pnp_dip_tpu" in run.guarded_modules()
    finally:
        del sys.modules["lrs_pnp_dip_tpu"]
    assert "lrs_pnp_dip_tpu" not in run.guarded_modules()


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "dataclasses", "math", "typing", "numpy", "torch"}
    for path in sorted((HERE / "reference").glob("*.py")):
        assert _imports(path) <= allowed, (path.name, _imports(path) - allowed)
