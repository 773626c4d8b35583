"""Each traffic driver's plumbing at a tiny size on the CPU (the measuring
path itself needs a card and exits 2 without one), and a cell added as data
alone, in a temporary copy of the benchmark, run by the copy's harness."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 4321

TINY = ROOT / "benchmark" / "tests" / "tiny"


def _tiny_file(name: str) -> dict:
    """``tests/tiny/<config>.json`` of cell ``name``, found by the cell's
    ``config``."""
    config = run.load_json(run.HERE / "workloads" / f"{name}.json")["config"]
    path = TINY / f"{config}.json"
    if not path.is_file():
        raise FileNotFoundError(
            f"cell {name!r}: configuration {config!r} has no CPU size; write "
            f"{path.relative_to(ROOT)}, overrides of configs/{config}.json under \"config\"")
    return run.load_json(path)


def tiny(name: str) -> dict:
    """The CPU size of cell ``name``: the overrides (``"config"``, and
    ``"cell"`` where the file has one) of its tiny file, with one traced
    job."""
    data = _tiny_file(name)
    over = {k: data[k] for k in ("cell", "config") if k in data}
    over.setdefault("cell", {})["trace_jobs"] = 1
    return over


def window(name: str) -> float:
    """Seconds of a CPU test's window at cell ``name``'s tiny size: the tiny
    file's ``"seconds"`` (long enough for a job to end in it on a loaded
    CPU), else 4."""
    return float(_tiny_file(name).get("seconds", 4.0))


# Every cell file, also one that BENCHMARK.json does not list yet.
CELLS = sorted(p.stem for p in (ROOT / "benchmark" / "workloads").glob("*.json"))


def cells_of(driver: str) -> list[str]:
    """The cells whose traffic driver is ``driver``."""
    return [c for c in CELLS
            if run.load_json(run.HERE / "workloads" / f"{c}.json")["driver"] == driver]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_driver_plumbing(name, trace):
    res, checks = run.run_cell(name, SEED, window(name), trace, torch.device("cpu"),
                               overrides=tiny(name))
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks" and len(checks) == len(res["checks"])
    listed = {w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}
    if trace:
        assert res["device"]["window_s"] > 0 and "breakdown" in res
    else:
        assert "setup_s" in res["metrics"] and (len(res["metrics"]) >= 2 or name not in listed)


def test_measuring_path_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


# A configuration added as files alone: its sizes, its CPU size, a cell.
NEW_CONFIG = "config4d32"


def _add_configuration(copy: Path, bench: dict) -> None:
    data = json.loads((ROOT / "benchmark/configs/config4.json").read_text())
    data.update(name=NEW_CONFIG, d=32, source=data["source"] + "; d=32")
    (copy / f"benchmark/configs/{NEW_CONFIG}.json").write_text(json.dumps(data))
    (copy / f"benchmark/tests/tiny/{NEW_CONFIG}.json").write_text(
        json.dumps({"config": {"K": 40, "S": 16, "d": 8}}))
    bench["configs"].append({"name": NEW_CONFIG, "source": data["source"],
                             "file": f"benchmark/configs/{NEW_CONFIG}.json", "reduced": [],
                             "why": "wider latents"})


@pytest.mark.parametrize("config", ["config4", NEW_CONFIG])
def test_a_cell_added_as_data(tmp_path, config):
    """A cell of an existing configuration, and one of a configuration that
    is new too, each added as files alone in a copy and run by the copy's
    harness at the copy's CPU size."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if config == NEW_CONFIG:
        _add_configuration(copy, bench)
    name = f"{config}.widen16"
    cell = {"name": name, "config": config, "traffic": "widen16", "chips": 1,
            "why": "widen band 16: K4"}
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "config4.diag16" in m.get("workloads", []):
            m["workloads"].append(name)
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    data = json.loads((ROOT / "benchmark/workloads/config4.diag16.json").read_text())
    data.update(config=config, traffic="widen16", why=cell["why"],
                params={"dtw": {"band": 16, "band_mode": "widen"}})
    (copy / f"benchmark/workloads/{name}.json").write_text(json.dumps(data))
    code = ("import json, sys, torch; sys.path[:0] = ['.', 'benchmark/tests']; "
            "from benchmark import run; from test_harness_drivers import tiny; "
            f"res, _ = run.run_cell({name!r}, 7, 3.0, False, torch.device('cpu'), "
            f"overrides=tiny({name!r})); print(json.dumps(res))")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["pairs_per_s"]["value"] > 0


def test_a_configuration_without_a_cpu_size(tmp_path, monkeypatch):
    """The CPU size is found by the cell's ``config``, not its name, and a
    configuration without one names the file to write."""
    monkeypatch.setattr(run, "HERE", tmp_path)
    (tmp_path / "workloads").mkdir()
    (tmp_path / "workloads" / "config4.other.json").write_text(json.dumps({"config": "nosize"}))
    with pytest.raises(FileNotFoundError, match="benchmark/tests/tiny/nosize.json"):
        tiny("config4.other")
