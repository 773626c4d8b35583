"""The port's native library (audio_pattern_discovery_tpu_torch/native.py):
built from the shared ``native/apd_native.cc`` into the port's own
``build/`` directory, with OpenMP where the compiler has it and without it
otherwise, and the library without OpenMP gives the default library's
results for the bindings the port calls (the clustering's NN-chain and the
bulk WAV loader)."""

import ctypes
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu_torch import native

torch.set_num_threads(1)

PKG = Path(native.__file__).resolve().parent


def test_library_is_built_into_the_port_build_dir():
    lib = native.get_lib()
    assert lib is not None
    assert native.LIB_PATH == PKG / "build" / "libapd_native.so"
    assert Path(lib._name).resolve() == native.LIB_PATH
    assert "native" not in Path(lib._name).resolve().parent.name
    assert native.openmp == native.links_openmp(native.LIB_PATH)


@pytest.fixture(scope="module")
def no_openmp_lib(tmp_path_factory):
    so = tmp_path_factory.mktemp("noomp") / "libapd_native.so"
    assert native.build_library(so, use_openmp=False)
    assert not native.links_openmp(so)
    return native.bind(ctypes.CDLL(str(so)))


def _default_and_no_openmp(no_openmp_lib, monkeypatch, fn):
    """``fn()`` on the default library, then on the one without OpenMP."""
    assert native.get_lib() is not None
    want = fn()
    monkeypatch.setattr(native, "_lib", no_openmp_lib)
    monkeypatch.setattr(native, "openmp", False)
    return want, fn()


def test_no_openmp_build_clusters_like_the_default(no_openmp_lib, monkeypatch):
    rng = np.random.default_rng(31)
    x = rng.normal(0, 1, (40, 3))
    dist = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    for method in ("single", "complete", "average", "weighted"):
        with monkeypatch.context() as m:
            want, got = _default_and_no_openmp(no_openmp_lib, m,
                                               lambda: native.nn_chain_cpp(dist, method))
        assert want.shape == (39, 4)
        np.testing.assert_array_equal(got, want)


def test_no_openmp_build_loads_wavs_like_the_default(no_openmp_lib, monkeypatch, tmp_path):
    rng = np.random.default_rng(32)
    paths = []
    for i, (n, rate) in enumerate(((1000, 16000), (2345, 16000), (7, 8000))):
        path = tmp_path / f"clip{i}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(rng.integers(-32768, 32768, n).astype("<i2").tobytes())
        paths.append(path)
    want, got = _default_and_no_openmp(no_openmp_lib, monkeypatch,
                                       lambda: native.load_wavs_batch(paths, n_threads=2))
    assert want is not None and want[0].shape == (3, 2345)
    np.testing.assert_array_equal(want[1], [1000, 2345, 7])
    np.testing.assert_array_equal(want[2], [16000, 16000, 8000])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
