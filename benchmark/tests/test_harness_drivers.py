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

TINY = {
    "config4": {"config": {"K": 48, "S": 16, "d": 4}},
    # The shipped AE (20 epochs) with minibatches of 256, so that each epoch
    # of the tiny corpus takes several steps.
    "config2": {"config": {"corpus": {"n_clips": 6, "clip_seconds": 3.0},
                           "pipeline": {"autoencoder.batch_size": 256}}},
}


def tiny(name: str) -> dict:
    over = json.loads(json.dumps(TINY[name.split(".")[0]]))
    over.setdefault("cell", {})["trace_jobs"] = 1
    return over


# Every cell file, also one that BENCHMARK.json does not list yet.
CELLS = sorted(p.stem for p in (ROOT / "benchmark" / "workloads").glob("*.json"))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_driver_plumbing(name, trace):
    res, checks = run.run_cell(name, SEED, 4.0, trace, torch.device("cpu"), overrides=tiny(name))
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


def test_a_cell_added_as_data(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {"name": "config4.widen16", "config": "config4", "traffic": "widen16", "chips": 1,
            "why": "widen band 16: K4"}
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "config4.diag16" in m.get("workloads", []):
            m["workloads"].append(cell["name"])
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    data = json.loads((ROOT / "benchmark/workloads/config4.diag16.json").read_text())
    data.update(traffic="widen16", why=cell["why"],
                params={"dtw": {"band": 16, "band_mode": "widen"}})
    (copy / "benchmark/workloads/config4.widen16.json").write_text(json.dumps(data))
    code = ("import json, sys, torch; sys.path.insert(0, 'benchmark'); import run; "
            "res, _ = run.run_cell('config4.widen16', 7, 3.0, False, torch.device('cpu'), "
            f"overrides={TINY['config4']!r}); print(json.dumps(res))")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=copy, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["pairs_per_s"]["value"] > 0
