"""The port's native library (audio_pattern_discovery_tpu_torch/native.py):
built from the shared ``native/apd_native.cc`` into the port's own
``build/`` directory, with OpenMP where the compiler has it and without it
otherwise, and the library without OpenMP scatters blocks exactly like the
NumPy twin the scheduler keeps for a host without a compiler."""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu_torch import native
from audio_pattern_discovery_tpu_torch.config import DTWConfig
from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as tps

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


@pytest.mark.parametrize("norm", ["none", "path_len"])
def test_no_openmp_build_scatters_like_numpy(no_openmp_lib, monkeypatch, norm):
    rng = np.random.default_rng(31)
    K, L, d = 37, 24, 3
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    lens = rng.integers(6, L + 1, K).astype(np.int32)
    cfg = DTWConfig(band=4, band_mode="diag", normalize=norm)
    monkeypatch.setattr(native, "_lib", no_openmp_lib)
    monkeypatch.setattr(native, "openmp", False)
    for direct in (True, False):
        if not direct:
            monkeypatch.setattr(tps, "_DIRECT_SCATTER_BYTES", 0)
        stats = {}
        got = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=8, stats=stats, device="cpu")
        assert stats["native_scatter"] and not stats["native_openmp"]
        with monkeypatch.context() as m:
            m.setenv("APD_NO_NATIVE_SCATTER", "1")
            want = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=8, stats=stats, device="cpu")
        assert not stats["native_scatter"]
        np.testing.assert_array_equal(got, want)


def test_block_scatter_no_openmp_equals_numpy(no_openmp_lib, monkeypatch):
    # One diagonal and one off-diagonal block straight into D.
    rng = np.random.default_rng(32)
    ti, K = 8, 13
    perm = rng.permutation(K).astype(np.int64)
    lens = rng.integers(4, 20, K).astype(np.float32)
    monkeypatch.setattr(native, "_lib", no_openmp_lib)
    for I, J in ((0, 0), (0, 1)):
        blk = rng.uniform(0, 10, (ti, ti)).astype(np.float32)
        nr, nc = min(ti, K - I * ti), min(ti, K - J * ti)
        lr, lc = lens[I * ti : I * ti + nr], lens[J * ti : J * ti + nc]
        got = np.zeros((K, K), np.float32)
        native.scatter_block_direct(blk, nr, nc, lr, lc, perm[I * ti : I * ti + nr],
                                    perm[J * ti : J * ti + nc], got, I == J)
        want = np.zeros((K, K), np.float32)
        b = blk[:nr, :nc] / (lr[:, None] + lc[None, :])
        if I == J:
            b = np.triu(b, k=1)
            b = b + b.T
        r, c = perm[I * ti : I * ti + nr], perm[J * ti : J * ti + nc]
        want[np.ix_(r, c)] = b
        if I != J:
            want[np.ix_(c, r)] = b.T
        np.testing.assert_array_equal(got, want)
