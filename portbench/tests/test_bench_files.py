"""Every name in BENCHMARK.json resolves to its files, and the file keeps to
the benchmark contract's keys and characters."""

import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys(section):
    for entry in BENCH[section]:
        extra = set(entry) - KEYS[section]
        assert set(entry) >= KEYS[section], entry
        assert extra <= ({"workloads"} if section in ("end_to_end", "per_layer") else set()), entry


@pytest.mark.parametrize("section", sorted(KEYS))
def test_names_and_units_use_allowed_characters(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_every_name_resolves_to_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        data = json.loads(path.read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        cell = json.loads((HERE / "cells" / f"{w['name']}.json").read_text())
        assert (HERE / "traffic" / f"{cell['kind']}.py").is_file()
        assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
            for w in m.get("workloads", ()):
                assert w in {x["name"] for x in BENCH["workloads"]}


def test_metrics_keep_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in BENCH["workloads"]:
        reported = [m for m in BENCH["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_configuration_files_are_the_ports_presets():
    import program

    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        over = {k: data["solver"][k] for k in data["reduced"]}
        assert program.solver_config(data["solver"]) == program.preset(data["preset"], **over)
        assert data["reduced_from"] if data["reduced"] else True
