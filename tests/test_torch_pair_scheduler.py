"""The port's tiled all-pairs scheduler
(audio_pattern_discovery_tpu_torch/parallel/pair_scheduler.py) against the
JAX scheduler on the same inputs, and the routes that raise.

Tolerance rtol 1e-5 / atol 1e-6 on path_len-normalized distances: both
sides compute the same corridor DP in fp32 (the JAX kernel from a Gram
expansion, the port from squared differences)."""

import numpy as np
import pytest
import torch

import audio_pattern_discovery_tpu.parallel.pair_scheduler as jps
from audio_pattern_discovery_tpu.config import DTWConfig as JCfg
from audio_pattern_discovery_tpu_torch.config import DTWConfig
from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as tps

torch.set_num_threads(1)


def _case(seed, K=40, L=32, d=4, lo=8):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    lens = rng.integers(lo, L + 1, K).astype(np.int32)
    return feats, lens


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_scheduler_matches_jax_tiled(metric):
    # tests/test_dtw_diag.py::test_diag_tiled_scheduler_matches_legacy's case
    feats, lens = _case(12)
    jcfg = JCfg(band=4, band_mode="diag", normalize="path_len", metric=metric)
    want = jps.all_pairs_distances_tiled(
        feats, lens, jcfg, interpret=True, geometry=(8, 0, 0), lane=True,
        chunk_programs=4,
    )
    cfg = DTWConfig(band=4, band_mode="diag", normalize="path_len", metric=metric)
    got = tps.all_pairs_distances(feats, lens, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.diag(got), 0.0)
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("ti,chunk", [(8, 4), (16, 64), (5, 3)])
def test_tiling_does_not_change_distances(ti, chunk):
    # Class contracts are exact, so D is the same for any tile size or
    # chunking; also against the JAX legacy per-pair path.
    feats, lens = _case(13, K=29)
    cfg = DTWConfig(band=3, band_mode="diag", normalize="path_len")
    stats = {}
    got = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=ti,
                                        chunk_programs=chunk, stats=stats)
    want = jps.all_pairs_distances(
        feats, lens, JCfg(band=3, band_mode="diag", normalize="path_len"), tiled=False
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    nT = -(-29 // ti)
    assert stats["tile_programs"] == nT * (nT + 1) // 2
    assert stats["pairs"] == 29 * 28 // 2


def test_unnormalized_torch_features_and_numpy_scatter(monkeypatch):
    # Tensor input (the pipeline's device-resident features), no
    # normalization, and the NumPy twin of the native scatter.
    feats, lens = _case(14, K=21)
    cfg = DTWConfig(band=5, band_mode="diag", normalize="none")
    with_native = tps.all_pairs_distances(torch.from_numpy(feats), lens, cfg)
    monkeypatch.setenv("APD_NO_NATIVE_SCATTER", "1")
    numpy_scatter = tps.all_pairs_distances(feats, lens, cfg)
    np.testing.assert_array_equal(with_native, numpy_scatter)
    want = jps.all_pairs_distances(
        feats, lens, JCfg(band=5, band_mode="diag", normalize="none"), tiled=False
    )
    np.testing.assert_allclose(with_native, want, rtol=1e-4, atol=1e-4)


def test_strip_assembly_matches_direct(monkeypatch):
    feats, lens = _case(15, K=23)
    cfg = DTWConfig(band=4, band_mode="diag", normalize="path_len")
    direct = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=4)
    monkeypatch.setattr(tps, "_DIRECT_SCATTER_BYTES", 0)
    strips = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=4)
    np.testing.assert_array_equal(direct, strips)
    monkeypatch.setenv("APD_NO_NATIVE_SCATTER", "1")
    np.testing.assert_array_equal(direct, tps.all_pairs_distances_tiled(feats, lens, cfg, ti=4))


def test_class_fn_and_merge_equal_jax():
    rng = np.random.default_rng(16)
    for _ in range(10):
        ti, nT = 8, int(rng.integers(2, 9))
        K = nT * ti - int(rng.integers(0, ti))
        lens_p = np.ones(nT * ti, np.int32)
        lens_p[:K] = np.sort(rng.integers(2, 200, K))
        band = int(rng.integers(1, 20))
        t_fn = tps.make_tile_lane_diag_class_fn(lens_p, nT, ti, 256, band, K)
        j_fn = jps.make_tile_lane_diag_class_fn(lens_p, nT, ti, 256, band, K)
        t_cls, j_cls = {}, {}
        for i in range(nT):
            for j in range(i, nT):
                assert t_fn(j, i) == j_fn(j, i)[:2]
                t_cls.setdefault(t_fn(j, i), []).append((j, i))
                j_cls.setdefault(j_fn(j, i)[:2], []).append((j, i))
        tps._merge_thin_classes(t_cls)
        jps._merge_thin_classes(j_cls)
        assert t_cls == j_cls


def test_tiny_corpus():
    cfg = DTWConfig(band=2, band_mode="diag")
    assert tps.all_pairs_distances(np.zeros((1, 4, 2), np.float32), [4], cfg).shape == (1, 1)


@pytest.mark.parametrize(
    "cfg,match",
    [
        (DTWConfig(band=None), "K2/K3"),
        (DTWConfig(band=4, band_mode="widen"), "K4-K7"),
        (DTWConfig(band=4, dtype="bfloat16"), "float32"),
    ],
)
def test_unported_routes_raise(cfg, match):
    feats, lens = _case(17, K=4)
    with pytest.raises(NotImplementedError, match=match):
        tps.all_pairs_distances(feats, lens, cfg)
