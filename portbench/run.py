#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell is the ``workloads`` entry of
``BENCHMARK.json`` called ``<name>``; its configuration is
``portbench/configs/<config>.json``, its traffic ``portbench/cells/<name>.json``
(the ``kind`` there names the driver, ``portbench/traffic/<kind>.py``), and
each metric is read by ``portbench/metrics/<metric>.py``.

A run makes its inputs from ``--seed``, builds and warms the program (set-up),
then sends the cell's requests in a closed loop, one client, until
``--seconds`` have passed (the window ends with the request that passes
them).  With ``--trace 1`` a bounded stretch of the same traffic follows
the window under ``torch.profiler``.  Then the program's state is freed and
the answers of the window are compared with the plain reference
(``portbench/reference/``), each number beside its limit.  The last line
of standard output is the result, one JSON object; the last lines of
standard error are the numbers compared.

It needs a CUDA card and fails without one: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GUARDED = ("jax", "jaxlib", "flax", "lrs_pnp_dip_tpu")  # top-level names no run may load


def _since_process_start() -> float:
    """Seconds since this process started, by the kernel's record of its
    start (10 ms resolution) against the boot clock."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str):
    """The reader ``read(run) -> float | None`` of metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, section: str, workload: str) -> list:
    """The metrics of ``section`` that ``workload`` reports."""
    return [m for m in bench[section] if "workloads" not in m or workload in m["workloads"]]


class Run:
    """What a metric reader reads: the window's records, the counts, and
    the traced stretch."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def build(workload: str, seed: int, device: str = "cuda", overrides: dict = None) -> tuple:
    """The cell's context and traffic driver, before set-up: (bench, ctx,
    driver).  ``overrides`` (tests only) updates the cell's and the
    configuration's sizes: ``{"cell": {...}, "problem": {...}, "solver":
    {...}, "dictionary": array}``."""
    import torch

    import program
    from reference import solver as ref
    from traffic.base import Context
    from yardstick import inputs

    overrides = overrides or {}
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    cell = {**load_json(HERE / "cells" / f"{workload}.json"), **overrides.get("cell", {})}
    problem = {**config["problem"], **overrides.get("problem", {})}
    solver = json.loads(json.dumps(config["solver"]))
    for key, value in overrides.get("solver", {}).items():
        solver[key] = {**solver[key], **value} if isinstance(value, dict) else value
    ctx = Context(
        workload=workload, seed=seed, device=torch.device(device), config=config, cell=cell,
        cfg=program.solver_config(solver), setup=ref.Setup.from_config(solver), problem=problem,
        dictionary=overrides.get("dictionary", inputs.load_dictionary(ROOT / problem["dictionary"])),
    )
    torch.set_num_threads(cell.get("host_threads", 4))
    return bench, ctx, importlib.import_module(f"traffic.{cell['kind']}").Driver(ctx)


def window(driver, seconds: float) -> tuple:
    """The closed loop: requests one after the other until ``seconds`` have
    passed; returns (records, failed requests, window seconds)."""
    records, failed, i = [], 0, 0
    w0 = time.perf_counter()
    while True:
        try:
            rec = driver.request(i)
        except Exception as e:  # a request that raises has failed; the window ends there
            print(f"request {i} failed: {type(e).__name__}: {e}", file=sys.stderr)
            failed += 1
            break
        records.append(rec)
        i += 1
        if rec.t1 - w0 >= seconds:
            break
    return records, failed, (records[-1].t1 if records else time.perf_counter()) - w0


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            overrides: dict = None) -> tuple:
    """One run; returns (result dict, compared numbers {name: (value, limit)})."""
    import torch

    from yardstick import peaks, trace as tr

    bench, ctx, driver = build(workload, seed, device, overrides)
    dev, cell = ctx.device, ctx.cell
    driver.setup()
    setup_s = _since_process_start()
    records, failed, window_s = window(driver, seconds)

    traced, breakdown = None, None
    if trace:
        traced = _profile(driver, dev, tr)
        breakdown = {"device_ops": tr.top_device_ops(traced.device), "idle_gaps": tr.idle_gaps(traced)}

    if dev.type == "cuda":
        memory_peak = int(torch.cuda.max_memory_allocated(dev))
        name = torch.cuda.get_device_name(dev)
    else:
        memory_peak, name = 0, "cpu"
    power = peaks.power_limit() if dev.type == "cuda" else "not read"
    run = Run(workload=workload, cell=cell, config=ctx.config, setup_s=setup_s,
              records=records, window_s=window_s, flops=sum(driver.flops(r) for r in records),
              device_name=name, peaks=peaks.peaks_for(name) if dev.type == "cuda" else None,
              power_limit=power, trace=traced, b1_work=driver.traced_b1_work() if trace else [])

    driver.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = driver.readings() if records else {}
    compared = {k: (float(v), float(cell["limits"][k])) for k, v in readings.items()}
    correct = bool(records) and failed == 0 and all(v <= lim for v, lim in compared.values())

    metrics = {}
    section = "per_layer" if trace else "end_to_end"
    for m in ([] if not records else cell_metrics(bench, section, workload)):
        value = load_metric(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    busy = {"busy_s": tr.busy_ns(traced.device) / 1e9, "window_s": traced.window_ns / 1e9} if trace else {}
    result = {
        "correct": correct,
        "attempted": len(records) + failed,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name, "count": 1,
                   "memory_peak_bytes": memory_peak, **busy, "power_limit": power},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result, compared


def _profile(driver, dev, tr):
    """Run the driver's traced stretch under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter_ns()
        driver.traced()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_ns = time.perf_counter_ns() - t0
    return tr.from_profile(prof, window_ns)


def guarded_modules() -> list:
    """Modules loaded in this process whose top-level name is guarded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(GUARDED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build caches at fixed places inside the checkout (the port builds B1 and
    # its host library into lrs_pnp_dip_tpu_torch/csrc/build/ itself)
    for name, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[name] = str(ROOT / ".bench_cache" / sub)

    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result, compared = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = guarded_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: the benchmark may not load JAX or the JAX package",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for k, (v, lim) in compared.items():
        print(f"compared {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
