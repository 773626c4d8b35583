"""The port's runtime extras on the CPU: ``utils/doctor.py`` (``--doctor``
and the worker's ``doctor`` request), ``utils/profiling.py`` (``--trace``)
and ``utils/timer.py``, mirroring the JAX package's tests/test_doctor.py and
tests/test_profiling.py.  The device probes and ``cuda_ms`` need a card:
``chip_smoke.py`` phase 30 runs them there; here the device entry must be
the guard's error, never a CPU measurement."""

import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu_torch.cli import main as cli_main
from audio_pattern_discovery_tpu_torch.config import PipelineConfig
from audio_pattern_discovery_tpu_torch.ops import _build
from audio_pattern_discovery_tpu_torch.synthetic import make_corpus
from audio_pattern_discovery_tpu_torch.utils import DeviceTimer, doctor
from audio_pattern_discovery_tpu_torch.utils.profiling import annotate, trace_to
from audio_pattern_discovery_tpu_torch.utils.timer import materialize, time_fn

torch.set_num_threads(1)

KEYS = {"versions", "host", "native_lib", "compile_cache", "env", "first_use_s",
        "first_use_counts"}


def test_report_keys_without_device_probes():
    rep = doctor.run_doctor(probe_device=False)
    assert set(rep) == KEYS
    assert rep["versions"]["torch"] == torch.__version__
    assert rep["versions"]["audio_pattern_discovery_tpu_torch"]
    assert rep["host"]["cpus"] >= 1
    assert isinstance(rep["native_lib"]["available"], bool)
    assert "native_openmp" in rep["native_lib"]
    cache = rep["compile_cache"]
    assert cache["dir"] == str(_build.BUILD_DIR)
    assert set(cache["libraries"]) == {p.stem for p in _build.CSRC_DIR.glob("*.cu")}
    assert len(cache["libraries"]) == 10
    assert set(cache["libraries"].values()) <= {"absent", "stale", "current"}
    json.dumps(rep)


def test_env_lists_the_ports_variables(monkeypatch):
    # The port reads no variable of its own: the report lists CUDA's two.
    monkeypatch.setenv("CUDA_HOME", "cuda-home")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    env = doctor.run_doctor(probe_device=False)["env"]
    assert env == {"CUDA_HOME": "cuda-home", "CUDA_VISIBLE_DEVICES": "0"}


def test_cli_doctor_flag(capsys, monkeypatch):
    # No card here (or made to look so): the device entry is the guard's error.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_main(["--doctor"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert set(rep) == KEYS | {"device"}
    assert rep["device"] == {"error": "RuntimeError: torch sees no CUDA card"}


@pytest.mark.parametrize("probe,key", [("_versions", "versions"), ("_host", "host"),
                                       ("_native", "native_lib"),
                                       ("_compile_cache", "compile_cache")])
def test_a_probe_that_raises_degrades_to_its_error(monkeypatch, probe, key):
    def boom():
        raise OSError("down")

    monkeypatch.setattr(doctor, probe, boom)
    rep = doctor.run_doctor(probe_device=False)
    assert rep[key] == {"error": "OSError: down"}
    assert all("error" not in rep[k] for k in KEYS - {key, "env"})


def test_device_probes_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rep = doctor.run_doctor(probe_device=True, hbm_mb=1)
    assert rep["device"] == {"error": "RuntimeError: torch sees no CUDA card"}


def test_compile_cache_without_nvcc(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    cache = doctor.run_doctor(probe_device=False)["compile_cache"]
    assert cache["nvcc"] == {"error": "RuntimeError: nvcc not found"}
    assert len(cache["libraries"]) == 10


@pytest.mark.parametrize("state", ["absent", "stale", "current"])
def test_library_state(tmp_path, monkeypatch, state):
    # A library is current when it is newer than its source and every
    # header, as _build.load_all rebuilds it otherwise.
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    (csrc / "k.cu").write_text("")
    (csrc / "h.cuh").write_text("")
    if state != "absent":
        so = build / "libk.so"
        so.write_bytes(b"\0" * 8)
        t = time.time()
        os.utime(csrc / "k.cu", (t - 100, t - 100))
        os.utime(csrc / "h.cuh", (t + (100 if state == "stale" else -100),) * 2)
        os.utime(so, (t, t))
    assert _build.library_state("k") == state
    if state == "current":
        cache = doctor._compile_cache()
        assert cache["entries"] == 1 and cache["bytes"] == 8
        assert cache["libraries"] == {"k": "current"}


def test_trace_to_writes_a_json_trace(tmp_path):
    with trace_to(tmp_path / "trace") as out:
        with annotate("test_span"):
            x = torch.ones((64, 64)) @ torch.ones((64, 64))
            materialize(x)
    assert out == str(tmp_path / "trace")
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "test_span" in names and any(str(n).startswith("aten::mm") for n in names)


def test_device_timer_and_time_fn_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": [x * 2, (x + 1,)]}

    x = torch.ones(16)
    t = time_fn(fn, x, warmup=2, iters=5)
    assert len(calls) == 7 and t >= 0.0
    with DeviceTimer() as timer:
        timer.block_on(fn(x), x)
        time.sleep(0.01)
    assert timer.elapsed_s >= 0.01
    materialize({"a": [x, (x,)], "b": 3})


def test_time_fn_is_the_median():
    waits = iter([0.0, 0.03, 0.001, 0.06])

    def fn():
        time.sleep(next(waits))
        return torch.zeros(1)

    assert 0.02 < time_fn(fn, warmup=1, iters=3) < 0.05


@pytest.fixture(scope="module")
def seed7(tmp_path_factory):
    d = tmp_path_factory.mktemp("seed7") / "corpus"
    make_corpus(d, n_clips=12, n_motifs=3, seed=7)
    return d


def _flags():
    return ["--device", "cpu", "-s", "dtw.band=16", "-s", "autoencoder.method=pca",
            "-s", "autoencoder.latent_dim=8", "-s", "output.write_images=false",
            "-s", "output.write_snippets=false", "-s", "output.write_html_report=false",
            "-s", "autoencoder.checkpoint=true"]


def _partition(out: Path):
    manifest = json.loads((out / "clusters.json").read_text())
    return sorted(tuple(sorted(m["segment"] for m in c["members"])) for c in manifest["clusters"])


def test_cli_trace_fresh_and_update(seed7, tmp_path, capsys):
    # --trace DIR wraps discover() for a fresh run and for --update: each
    # writes a trace, and clusters.json keeps the partition of a run
    # without it.
    # The trace holds one range apd.<stage> for each stage of the run's
    # timings_s, on the same timeline as the operators.
    plain, traced = tmp_path / "plain", tmp_path / "traced"
    assert cli_main([str(seed7), "-o", str(plain), *_flags()]) == 0
    capsys.readouterr()
    assert cli_main([str(seed7), "-o", str(traced), "--trace", str(tmp_path / "t1"),
                     *_flags()]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert _partition(traced) == _partition(plain)
    np.testing.assert_array_equal(np.load(traced / "distance_matrix.npy"),
                                  np.load(plain / "distance_matrix.npy"))
    (trace1,) = (tmp_path / "t1").glob("*.json")
    events = json.loads(trace1.read_text())["traceEvents"]
    names = [e.get("name") for e in events]
    assert any(str(n).startswith("aten::") for n in names)
    assert "write_artifacts" in summary["timings_s"]
    for key in summary["timings_s"]:
        assert names.count(f"apd.{key}") == 1, key
    # An update with nothing new: the same partition, and its own trace.
    assert cli_main([str(seed7), "-o", str(traced), "--update", "--trace",
                     str(tmp_path / "t2"), *_flags()]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["counts"]["dtw_pairs_reused"] > 0
    assert _partition(traced) == _partition(plain)
    (trace2,) = (tmp_path / "t2").glob("*.json")
    names = [e.get("name") for e in json.loads(trace2.read_text())["traceEvents"]]
    for key in summary["timings_s"]:
        assert names.count(f"apd.{key}") == 1, key


def test_worker_doctor_request():
    from audio_pattern_discovery_tpu_torch.serve import _handle

    rep = _handle({"cmd": "doctor"}, PipelineConfig(), None, torch.device("cpu"))
    assert set(rep) == KEYS
    json.dumps(rep)
