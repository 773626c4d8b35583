"""BENCHMARK.json keeps to the contract's shape and character rules, and
every configuration, cell, driver and metric it names is a file found by
name."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in names
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
            names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_keys_and_bounds():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for w in m["workloads"]:
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        reported = [m for m in BENCH["end_to_end"] if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])


def test_every_name_is_a_file():
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = json.loads((HERE / "workloads" / f"{w['name']}.json").read_text())
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert (HERE / "traffic" / f"{cell['driver']}.py").is_file()
        assert set(cell["limits"]) and int(cell["trace_jobs"]) >= 1
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_paths_hold_only_allowed_names():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
