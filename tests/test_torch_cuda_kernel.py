"""The seam of the hand-written CUDA kernels (``ops/cuda_kernel.py``) on the
CPU: a kernel's launch accounting (eager, captured, replayed, reset), the
registry that a captured graph reads its held launches from, and the rule
that the build and the graph accounting live in that one module.  The
kernels themselves run in ``tests/test_torch_cuda.py``."""

import ast
import gc
import os
import subprocess
import sys
import types
import weakref
from pathlib import Path

import pytest
import torch

from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, SN_KERNEL
from lrs_pnp_dip_tpu_torch.ops.cuda_kernel import (
    NVCC_FLAGS, HandWrittenKernel, capture_marks, check_operand, held_since,
)
from lrs_pnp_dip_tpu_torch.ops.ista_cuda import H100_RESIDENT_CLUSTERS, FusedIstaKernel, kernel_name, plan_ista

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "lrs_pnp_dip_tpu_torch"


class _Fake(HandWrittenKernel):
    """A kernel that builds nothing: its launch only counts."""

    label = "fake"

    def launch(self, plan, err=0):
        self.launched(plan, err, 3)


def _capturing(monkeypatch, on: bool):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: on)


def test_an_eager_launch_a_captured_one_a_replay_and_a_reset(monkeypatch):
    kernel = _Fake()
    assert (kernel.launches, kernel.captured, kernel.last_plan, kernel.flags) == (0, 0, None, NVCC_FLAGS)
    _capturing(monkeypatch, False)
    kernel.launch("a")
    assert (kernel.launches, kernel.captured, kernel.last_plan) == (1, 0, "a")
    _capturing(monkeypatch, True)
    kernel.launch("b")
    kernel.launch("c")
    assert (kernel.launches, kernel.captured, kernel.last_plan) == (1, 2, "c")
    kernel.replayed(5, "r")
    assert (kernel.launches, kernel.captured, kernel.last_plan) == (6, 2, "r")
    kernel.reset_counts()
    assert (kernel.launches, kernel.captured, kernel.last_plan) == (0, 0, None)
    assert kernel._lib is None and kernel.build_log == ""


def test_a_refused_launch_raises_and_counts_nothing(monkeypatch):
    kernel = _Fake()
    _capturing(monkeypatch, False)
    plan = types.SimpleNamespace(cluster_size=8, smem_bytes=1024)
    with pytest.raises(RuntimeError, match="fake kernel launch refused: cudaError_t 1 for 3 clusters "
                                           "of 8 CTAs with 1024 B of shared memory each"):
        kernel.launch(plan, err=1)
    assert (kernel.launches, kernel.captured, kernel.last_plan) == (0, 0, None)


def test_a_capture_holds_the_launches_made_since_its_marks(monkeypatch):
    """What ``graphs.Captured`` records around a capture: the launches of
    each kernel the capture recorded and the tiling of the last, and none
    of a kernel it did not launch."""
    first, second, idle = _Fake(), _Fake(), _Fake()
    _capturing(monkeypatch, True)
    first.launch("before")  # a capture before the marks
    marks = capture_marks()
    first.launch("p")
    first.launch("q")
    second.launch("s")
    late = _Fake()  # made during the capture
    late.launch("t")
    held = held_since(marks)
    assert held == {first: (2, "q"), second: (1, "s"), late: (1, "t")}
    assert idle not in held and ISTA_KERNEL not in held and SN_KERNEL not in held
    _capturing(monkeypatch, False)
    for kernel, (n, plan) in held.items():
        kernel.replayed(n, plan)
    assert (first.launches, second.launches, late.launches, idle.launches) == (2, 1, 1, 0)


def test_the_registry_holds_the_port_kernels_and_drops_throwaway_ones():
    assert {ISTA_KERNEL, SN_KERNEL} <= set(capture_marks())
    kernel = _Fake()
    assert kernel in capture_marks()
    gone = weakref.ref(kernel)
    del kernel
    gc.collect()
    assert gone() is None  # the registry holds it weakly


def test_b1_counts_its_launches_by_cuda_kernel_too(monkeypatch):
    kernel = FusedIstaKernel()
    assert kernel.flags == NVCC_FLAGS and FusedIstaKernel(extra_flags=("-DX",)).flags == NVCC_FLAGS + ("-DX",)
    plan = plan_ista(144, 1296, 512, False, H100_RESIDENT_CLUSTERS)
    _capturing(monkeypatch, False)
    kernel.launched(plan, 0, plan.n_clusters)
    kernel.replayed(3, plan)
    assert kernel.launches == 4 and kernel.launches_by_kernel == {kernel_name(plan): 4}
    _capturing(monkeypatch, True)
    kernel.launched(plan, 0, plan.n_clusters)
    assert kernel.launches == 4 and kernel.captured == 1
    kernel.reset_counts()
    assert (kernel.launches, kernel.captured, kernel.last_plan, dict(kernel.launches_by_kernel)) == (0, 0, None, {})


@pytest.mark.parametrize(
    "t,shape,error,match",
    [
        (torch.zeros(3), None, ValueError, "x must be on the CUDA device"),
        (torch.zeros(3, device="meta"), (3,), ValueError, "x must be on the CUDA device"),
    ],
    ids=["cpu", "meta"],
)
def test_operands_off_the_card_are_refused(t, shape, error, match):
    with pytest.raises(error, match=match):
        check_operand("x", t, torch.device("cuda:0"), shape)


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def test_only_the_seam_builds_and_counts_captures():
    """One module of the port defines the nvcc build and its flags, and
    neither the spectral norm's wrapper, B1's, nor the graph module reads a
    kernel's captured count or defines a build."""
    defining = set()
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(_tree(path)):
            if isinstance(node, ast.FunctionDef) and node.name in ("build_library", "_nvcc"):
                defining.add(path.name)
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id.endswith("NVCC_FLAGS") for t in node.targets
            ):
                defining.add(path.name)
    assert defining == {"cuda_kernel.py"}
    for rel in ("ops/spectral_norm_cuda.py", "ops/ista_cuda.py", "solvers/graphs.py"):
        tree = _tree(PORT / rel)
        read = {node.attr for node in ast.walk(tree) if isinstance(node, ast.Attribute)}
        assert "captured" not in read, rel
        defined = {node.name for node in ast.walk(tree) if isinstance(node, ast.FunctionDef)}
        assert "build" not in defined and "build_library" not in defined, rel
    for rel in ("ops/spectral_norm_cuda.py", "solvers/graphs.py"):
        assert "last_plan" not in {n.attr for n in ast.walk(_tree(PORT / rel)) if isinstance(n, ast.Attribute)}, rel
    imports = [n for n in ast.walk(_tree(PORT / "ops/spectral_norm_cuda.py")) if isinstance(n, ast.ImportFrom)]
    assert all(n.module != "ista_cuda" for n in imports)


_IMPORT_PROBE = """
import ctypes, os, sys
import torch
loaded = []
real_init = ctypes.CDLL.__init__
def recording(self, name, *args, **kwargs):
    loaded.append(str(name))
    real_init(self, name, *args, **kwargs)
ctypes.CDLL.__init__ = recording
import lrs_pnp_dip_tpu_torch
from lrs_pnp_dip_tpu_torch import ops, solvers, parallel, models
from lrs_pnp_dip_tpu_torch.ops import ISTA_KERNEL, SN_KERNEL
from lrs_pnp_dip_tpu_torch.ops.cuda_kernel import capture_marks
assert {ISTA_KERNEL, SN_KERNEL} <= set(capture_marks())
assert ISTA_KERNEL._lib is None and SN_KERNEL._lib is None
port = os.path.dirname(lrs_pnp_dip_tpu_torch.__file__)
assert not [p for p in loaded if p.startswith(port)], loaded
print("NOTHING BUILT")
"""


def test_importing_the_port_builds_and_loads_no_kernel():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_PROBE],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["NOTHING", "BUILT"]
