"""The port's tracing on the CPU: the stage timers of
``utils/logging.StageCounters`` (dotted child keys, the AE stage split into
its scaler fit and its steps), their ranges ``apd.<key>`` on a
``torch.profiler`` timeline, ``utils/profiling.annotate`` without a
profiler, and the process's one-time costs in ``FIRST_USE`` (kernel builds
and loads, the native library, the optimizer's first construction)."""

import contextlib
import json
import os
import stat

import _ctypes
import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu_torch import native
from audio_pattern_discovery_tpu_torch.config import PipelineConfig
from audio_pattern_discovery_tpu_torch.models import autoencoder as tae
from audio_pattern_discovery_tpu_torch.ops import _build
from audio_pattern_discovery_tpu_torch.pipeline import discover
from audio_pattern_discovery_tpu_torch.synthetic import make_corpus
from audio_pattern_discovery_tpu_torch.utils.logging import FIRST_USE, StageCounters
from audio_pattern_discovery_tpu_torch.utils.profiling import annotate, profiling, trace_to

torch.set_num_threads(1)

CHILDREN = ("autoencoder_train.scaler_fit", "autoencoder_train.steps")


def _small_ae_config(**overrides) -> PipelineConfig:
    cfg = PipelineConfig()
    cfg.spectrogram.sample_rate = 16_000
    cfg.spectrogram.win_length = 256
    cfg.spectrogram.hop_length = 128
    cfg.spectrogram.max_bins = 32
    cfg.segmentation.threshold_db = -25.0
    cfg.segmentation.min_len_frames = 6
    cfg.autoencoder.epochs = 3
    cfg.autoencoder.batch_size = 64
    cfg.autoencoder.hidden_dims = (16,)
    cfg.autoencoder.latent_dim = 4
    cfg.dtw.max_seq_len = 64
    cfg.dtw.pair_batch = 64
    cfg.output.write_images = False
    return cfg.override(overrides)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing") / "corpus"
    make_corpus(d, n_clips=6, n_motifs=2, clip_seconds=1.5, seed=3)
    return d


def _expected_steps(counts: dict, cfg: PipelineConfig) -> int:
    """epochs x batches of the AE's pool (``_quantize_pool``'s size)."""
    n = len(tae._quantize_pool(np.zeros((int(counts["ae_train_frames"]), 1)), cfg.autoencoder.seed))
    return cfg.autoencoder.epochs * max(1, n // min(cfg.autoencoder.batch_size, n))


def test_ae_stage_splits_into_children(corpus):
    # The AE stage's children: the scaler's fit and the steps (ending in the
    # losses on the host), within their parent; ae_steps = epochs x batches.
    cfg = _small_ae_config()
    res = discover(corpus, cfg, device="cpu")
    t, counts = res.counters.timings_s, res.counters.counts
    assert set(CHILDREN) <= set(t)
    assert "autoencoder_train.steps_enqueued" not in t
    assert sum(t[k] for k in CHILDREN) <= t["autoencoder_train"]
    assert counts["ae_steps"] == _expected_steps(counts, cfg) > cfg.autoencoder.epochs
    assert len(res.ae_losses) == cfg.autoencoder.epochs
    # Every dotted key is a child of a recorded key.
    assert all(k.rpartition(".")[0] in t for k in t if "." in k)


def test_two_phase_steps_are_recorded_as_enqueued(corpus):
    # On the two-phase path the AE trains beside the second phase's
    # spectrograms and returns its losses on the device: the steps' span
    # ends at the last enqueue and says so by its key.
    cfg = _small_ae_config(**{"autoencoder.overlap_clip_fraction": 0.5})
    res = discover(corpus, cfg, device="cpu")
    t = res.counters.timings_s
    assert "autoencoder_train.steps_enqueued" in t and "autoencoder_train.steps" not in t
    assert res.counters.counts["ae_steps"] == _expected_steps(res.counters.counts, cfg)
    assert len(res.ae_losses) == cfg.autoencoder.epochs


def test_trace_holds_a_range_for_each_stage_and_step(corpus, tmp_path):
    # Under a profiler each stage is one range apd.<key> on the operators'
    # timeline, nested as its key, and each AE step one apd.ae.step range.
    cfg = _small_ae_config()
    with trace_to(tmp_path / "t"):
        res = discover(corpus, cfg, device="cpu")
    (path,) = (tmp_path / "t").glob("*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    by_name: dict = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    t, counts = res.counters.timings_s, res.counters.counts
    for key in t:
        assert len(by_name.get(f"apd.{key}", [])) == 1, key
    steps = by_name["apd.ae.step"]
    assert len(steps) == counts["ae_steps"]

    def inside(inner, outer):
        return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]

    (parent,) = by_name["apd.autoencoder_train"]
    (span,) = by_name["apd.autoencoder_train.steps"]
    assert inside(span, parent)
    assert all(inside(s, span) for s in steps)
    assert any(str(n).startswith("aten::addmm") for n in by_name)


def test_annotate_is_a_null_context_without_a_profiler(tmp_path):
    assert not profiling()
    assert isinstance(annotate("apd.x"), contextlib.nullcontext)
    with trace_to(tmp_path / "t"):
        assert profiling()
        rng = annotate("apd.x")
        assert not isinstance(rng, contextlib.nullcontext)
        with rng:
            torch.ones(4).add_(1)
    assert not profiling()


def test_first_use_times_each_key_once(monkeypatch):
    reg = StageCounters()
    with reg.first_use("a"):
        pass
    first = reg.timings_s["a"]
    for _ in range(3):
        with reg.first_use("a"):
            torch.ones(64).sum()
    assert reg.timings_s == {"a": first}
    with reg.first_use("b"):
        pass
    assert set(reg.timings_s) == {"a", "b"}
    # The optimizer's first construction in the process, once.
    monkeypatch.setattr(tae, "FIRST_USE", reg)
    cfg = _small_ae_config().autoencoder
    tae.init_state(cfg, 8, device="cpu")
    once = reg.timings_s["optimizer_first_use"]
    tae.init_state(cfg, 8, device="cpu")
    assert reg.timings_s["optimizer_first_use"] == once
    assert not reg.counts


def _fake_nvcc(tmp_path):
    """An ``nvcc`` that writes a loadable library (a copy of ``_ctypes``)
    to its ``-o`` and a ptxas line to standard error."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
                    f'cp "{_ctypes.__file__}" "$out"\n'
                    'echo "ptxas info    : Used 12 registers" >&2\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return str(nvcc)


def test_a_rebuilt_library_is_reported(tmp_path, monkeypatch):
    # A stale library is built again and counted (kernel_builds,
    # kernel_build.<name>, its ptxas report in build_info); loading it again
    # in the process builds nothing, and a process that finds it current
    # reports no build, only its load.
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("")
    reg = StageCounters()
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_info", {})
    monkeypatch.setattr(_build, "FIRST_USE", reg)
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    assert _build.library_state("k") == "absent"
    _build.load("k")
    assert reg.counts == {"kernel_builds": 1}
    assert {"kernel_build", "kernel_build.k", "kernel_load", "kernel_load.k"} == set(reg.timings_s)
    assert reg.timings_s["kernel_build.k"] <= reg.timings_s["kernel_build"]
    assert "Used 12 registers" in _build.build_info["k"]
    before = dict(reg.timings_s)
    _build.load("k")
    assert reg.timings_s == before and reg.counts == {"kernel_builds": 1}

    fresh = StageCounters()
    monkeypatch.setattr(_build, "FIRST_USE", fresh)
    monkeypatch.setattr(_build, "_libs", {})
    assert _build.library_state("k") == "current"
    _build.load("k")
    assert not fresh.counts and set(fresh.timings_s) == {"kernel_load", "kernel_load.k"}


@pytest.mark.parametrize("stale", [False, True], ids=["current", "stale"])
def test_native_load_is_recorded(tmp_path, monkeypatch, stale):
    # native.get_lib's first call in the process: its seconds, and the
    # build's as a child when the library had to be built.
    lib = tmp_path / "libapd_native.so"
    reg = StageCounters()
    built = []

    def build(out, use_openmp=True):
        built.append(out)
        out.write_bytes(open(_ctypes.__file__, "rb").read())
        return True

    if not stale:
        build(lib)
        built.clear()
    monkeypatch.setattr(native, "LIB_PATH", lib)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setattr(native, "FIRST_USE", reg)
    monkeypatch.setattr(native, "build_library", build)
    monkeypatch.setattr(native, "bind", lambda lib: lib)
    monkeypatch.setattr(native, "openmp", None)
    if stale:
        assert not lib.exists()
    else:
        os.utime(lib, (2 ** 31, 2 ** 31))
    assert native.get_lib() is not None
    native.get_lib()
    want = {"native_load", "native_load.build"} if stale else {"native_load"}
    assert set(reg.timings_s) == want
    assert len(built) == int(stale)
    if stale:
        assert reg.timings_s["native_load.build"] <= reg.timings_s["native_load"]


def test_cli_summary_and_doctor_carry_first_use(corpus, tmp_path, capsys):
    from audio_pattern_discovery_tpu_torch.cli import main as cli_main
    from audio_pattern_discovery_tpu_torch.utils.doctor import run_doctor

    assert cli_main([str(corpus), "-o", str(tmp_path / "out"), "--device", "cpu",
                     "-s", "autoencoder.method=pca", "-s", "autoencoder.latent_dim=4",
                     "-s", "output.write_images=false", "-s", "output.write_snippets=false"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["first_use_s"] == FIRST_USE.timings_s
    assert summary["first_use_counts"] == FIRST_USE.counts
    assert "write_artifacts" in summary["timings_s"]
    rep = run_doctor(probe_device=False)
    assert "native_load" in rep["first_use_s"]
    assert rep["first_use_counts"] == dict(FIRST_USE.counts)
