"""The port's tiled all-pairs scheduler
(audio_pattern_discovery_tpu_torch/parallel/pair_scheduler.py) against the
JAX scheduler on the same inputs, and the routes that leave it.

Tolerance rtol 1e-5 / atol 1e-6 on path_len-normalized distances: both
sides compute the same corridor DP in fp32 (the JAX kernel from a Gram
expansion, the port from squared differences)."""

import numpy as np
import pytest
import torch

import audio_pattern_discovery_tpu.parallel.pair_scheduler as jps
from audio_pattern_discovery_tpu.config import DTWConfig as JCfg
from audio_pattern_discovery_tpu_torch.config import DTWConfig
from audio_pattern_discovery_tpu_torch.ops import dtw_scatter as ds
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
    got = tps.all_pairs_distances(feats, lens, cfg, device="cpu")
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
                                        chunk_programs=chunk, stats=stats, device="cpu")
    want = jps.all_pairs_distances(
        feats, lens, JCfg(band=3, band_mode="diag", normalize="path_len"), tiled=False
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    nT = -(-29 // ti)
    assert stats["tile_programs"] == nT * (nT + 1) // 2
    assert stats["pairs"] == 29 * 28 // 2


def test_unnormalized_torch_features_and_numpy_scatter():
    # Tensor input (the pipeline's device-resident features), no
    # normalization: D bitwise the array input's, and the JAX per-pair D.
    feats, lens = _case(14, K=21)
    cfg = DTWConfig(band=5, band_mode="diag", normalize="none")
    from_tensor = tps.all_pairs_distances(torch.from_numpy(feats), lens, cfg, device="cpu")
    from_array = tps.all_pairs_distances(feats, lens, cfg, device="cpu")
    np.testing.assert_array_equal(from_tensor, from_array)
    want = jps.all_pairs_distances(
        feats, lens, JCfg(band=5, band_mode="diag", normalize="none"), tiled=False
    )
    np.testing.assert_allclose(from_tensor, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rows", [1, 7, 5], ids=["row", "seven_rows", "not_a_multiple"])
def test_strip_assembly_matches_direct(monkeypatch, rows):
    # D's columns un-permuted in panels of a few rows (the twin's panels,
    # as the card's scratch-row kernel takes them) bitwise in one panel;
    # K = 21 is a multiple of 1 and 7 rows, not of 5.
    feats, lens = _case(15, K=21)
    cfg = DTWConfig(band=4, band_mode="diag", normalize="path_len")
    one_panel = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=4, device="cpu")
    monkeypatch.setattr(ds, "_PANEL_BYTES", rows * 4 * 21)
    panels = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=4, device="cpu")
    np.testing.assert_array_equal(one_panel.view(np.int32), panels.view(np.int32))


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
    D = tps.all_pairs_distances(np.zeros((1, 4, 2), np.float32), [4], cfg, device="cpu")
    assert D.shape == (1, 1)


@pytest.mark.parametrize(
    "cfg,tiled_dtype",
    [
        (DTWConfig(band=None, max_seq_len=8192), None),
        (DTWConfig(band=4, band_mode="widen", max_seq_len=8192), None),
        (DTWConfig(band=4, dtype="bfloat16"), "float32"),
    ],
)
def test_unported_routes_raise(cfg, tiled_dtype):
    # The jobs no tiled route runs, which raised until they were ported.
    # Unbanded and widen jobs padded past 4096 frames run per pair, as in
    # the reference, and give the JAX package's D (here with short real
    # lengths, so K6 takes every bucket; tests/test_torch_dtw_long.py holds
    # K8's buckets); forced onto the tiled route they raise.  A bfloat16
    # job runs per pair with the bf16 Gram (diag band: the plain dtw_batch)
    # and gives the JAX package's bf16 D (tests/test_torch_bf16.py derives
    # the tolerance; 1e-5 here covers it); forced onto the tiled route it
    # runs there in ``tiled_dtype``, as the reference's tile kernels do.
    feats, lens = _case(17, K=4, L=cfg.max_seq_len if cfg.max_seq_len > 4096 else 32)
    if tiled_dtype is None:
        lens = (8 + lens % 300).astype(np.int32)
    stats = {}
    got = tps.all_pairs_distances(feats, lens, cfg, device="cpu", stats=stats)
    assert stats["route"] == "per_pair"
    want = jps.all_pairs_distances(
        feats, lens, JCfg(band=cfg.band, band_mode=cfg.band_mode,
                          max_seq_len=cfg.max_seq_len, dtype=cfg.dtype))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if tiled_dtype is None:
        with pytest.raises(ValueError, match="no tiled route"):
            tps.all_pairs_distances(feats, lens, cfg, device="cpu", tiled=True)
        return
    f32 = DTWConfig(band=cfg.band, band_mode=cfg.band_mode, dtype=tiled_dtype)
    np.testing.assert_array_equal(
        tps.all_pairs_distances(feats, lens, cfg, device="cpu", tiled=True),
        tps.all_pairs_distances(feats, lens, f32, device="cpu"))
    assert np.abs(got - tps.all_pairs_distances(feats, lens, f32, device="cpu")).max() > 1e-4


@pytest.mark.parametrize(
    "L,route",
    [(8, "tile"), (200, "tile"), (256, "tile"), (257, "full"), (1024, "full"),
     (4096, "full"), (4097, "per_pair")],
)
def test_unbanded_route_by_length(L, route):
    # The reference's routing: the time axis padded to a multiple of 128,
    # the square tile kernel up to 256, the full-width kernel up to 4096,
    # and past that no tiled route: the per-pair scheduler (K8).
    cfg = DTWConfig(band=None)
    assert tps.route_for(L, cfg) == route
    assert tps.route_for(L, DTWConfig(band=4, band_mode="diag")) == "diag"


def test_unbanded_class_fns_equal_jax():
    rng = np.random.default_rng(18)
    for trial in range(12):
        ti, nT = 8, int(rng.integers(2, 9))
        K = nT * ti - int(rng.integers(0, ti))
        Lp = 256 if trial % 2 else 1024
        lens_p = np.ones(nT * ti, np.int32)
        lens_p[:K] = np.sort(rng.integers(2, Lp + 1, K))
        band = None if trial % 3 == 0 else int(rng.integers(1, 40))
        pairs = [(i, j) for i in range(nT) for j in range(i, nT)]
        fns = [
            (tps.make_tile_pair_class_fn(lens_p, nT, ti, Lp, band, bool(trial % 2)),
             jps.make_tile_pair_class_fn(lens_p, nT, ti, Lp, band, bool(trial % 2))),
            (tps.make_tile_lane_full_class_fn(lens_p, nT, ti, Lp, K),
             jps.make_tile_lane_full_class_fn(lens_p, nT, ti, Lp, K)),
        ]
        for t_fn, j_fn in fns:
            t_cls, j_cls = {}, {}
            for p in pairs:
                assert t_fn(*p) == j_fn(*p)
                t_cls.setdefault(t_fn(*p), []).append(p)
                j_cls.setdefault(j_fn(*p), []).append(p)
            tps._merge_thin_classes(t_cls)
            jps._merge_thin_classes(j_cls)
            assert t_cls == j_cls


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_unbanded_tile_route_matches_jax_tiled(metric):
    # tests/test_dtw_tile.py::test_tiled_scheduler_matches_legacy with
    # band=None: the JAX square tile kernel against the port's K2 route.
    feats, lens = _case(19, K=40, L=32, d=5, lo=6)
    jcfg = JCfg(band=None, normalize="path_len", metric=metric)
    want = jps.all_pairs_distances_tiled(feats, lens, jcfg, interpret=True,
                                         geometry=(16, 4, 8))
    stats = {}
    got = tps.all_pairs_distances_tiled(
        feats, lens, DTWConfig(band=None, normalize="path_len", metric=metric), stats=stats,
        device="cpu")
    assert stats["route"] == "tile"
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.diag(got), 0.0)
    np.testing.assert_array_equal(got, got.T)


def test_unbanded_full_route_matches_jax_tiled():
    # tests/test_dtw_lane_full.py::test_full_scheduler_matches_legacy with
    # a padded length that takes the port's K3 route (L > 256), against the
    # JAX full-width lane kernel and the legacy per-pair path.  The real
    # lengths stay short: the JAX kernel's interpret mode pays per DP row.
    rng = np.random.default_rng(20)
    feats = rng.normal(0, 1, (10, 264, 3)).astype(np.float32)
    lens = rng.integers(12, 48, 10).astype(np.int32)
    jcfg = JCfg(band=None, normalize="path_len")
    want = jps.all_pairs_distances_tiled(feats, lens, jcfg, interpret=True,
                                         geometry=(4, 0, 0), lane=True)
    stats = {}
    got = tps.all_pairs_distances_tiled(feats, lens, DTWConfig(band=None, normalize="path_len"),
                                        ti=4, stats=stats, device="cpu")
    assert stats["route"] == "full"
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    legacy = jps.all_pairs_distances(feats, lens, jcfg, tiled=False)
    np.testing.assert_allclose(got, legacy, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.diag(got), 0.0)
