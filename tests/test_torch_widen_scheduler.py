"""The port's widen route (K4 and K5) in the tiled scheduler, the card's
per-class K4/K5 gate, and the per-pair scheduler
(``all_pairs_distances(..., tiled=False)``), against the JAX package's
scheduler on the same inputs.

Tolerance rtol 1e-4 / atol 1e-5 on path_len-normalized distances (1e-4 /
1e-4 unnormalized): the JAX per-pair path builds costs from a Gram
expansion, the port's twins from squared differences."""

import numpy as np
import pytest
import torch

import audio_pattern_discovery_tpu.parallel.pair_scheduler as jps
from audio_pattern_discovery_tpu.config import DTWConfig as JCfg
from audio_pattern_discovery_tpu_torch.config import DTWConfig
from audio_pattern_discovery_tpu_torch.ops import dtw_cuda as tk
from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as tps

torch.set_num_threads(1)


def _case(seed, K=30, L=32, d=4, lo=6):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    lens = rng.integers(lo, L + 1, K).astype(np.int32)
    for k in range(K):
        feats[k, lens[k]:] = 0.0
    return feats, lens


def _cfgs(**kw):
    return DTWConfig(**kw), JCfg(**kw)


def test_widen_gate(monkeypatch):
    # The card's gate is per class: K4 up to a 320-slot class stripe
    # (half-width level 159 on the 16-slot ladder), K5 above; widen jobs of
    # any padded length up to 4096 take the widen route.
    assert tps.widen_kernel(159) is tk.dtw_tile_lane_pairs
    assert tps.widen_kernel(160) is tk.dtw_tile_stripe_pairs
    widen = DTWConfig(band=16, band_mode="widen")
    assert tps.route_for(128, widen) == tps.route_for(4096, widen) == "widen"
    assert tps.route_for(4097, widen) == "per_pair"
    # A job with narrow and wide classes (the gate lowered to 64 slots, so a
    # small job has both) launches each class on its kernel (thin classes
    # kept apart here); forcing K5 gives the same D (on the CPU both run the
    # same twin).
    monkeypatch.setattr(tps, "LANE_MAX_W", 64)
    monkeypatch.setattr(tps, "_merge_thin_classes", lambda by_class: None)
    feats, lens = _case(20, K=40, L=64, lo=4)
    calls = []

    def spy(kernel):
        def run(*args, **kw):
            calls.append((kernel, kw["wv_max"], kw["frames"]))
            return kernel(*args, **kw)
        return run

    monkeypatch.setattr(tps, "dtw_tile_lane_pairs", spy(tk.dtw_tile_lane_pairs))
    monkeypatch.setattr(tps, "dtw_tile_stripe_pairs", spy(tk.dtw_tile_stripe_pairs))
    cfg = DTWConfig(band=4, band_mode="widen", normalize="path_len")
    got = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=8, device="cpu")
    assert {k for k, _, _ in calls} == {tk.dtw_tile_lane_pairs, tk.dtw_tile_stripe_pairs}
    assert all((k is tk.dtw_tile_lane_pairs) == (2 * wv + 2 <= 64) for k, wv, _ in calls)
    # Each kernel gets one layout, built once for the job: K4 the strip
    # layout, K5 the frame layout, of the sorted corpus padded to 128 frames.
    for kernel, shape in ((tk.dtw_tile_lane_pairs, (5, 128, 8, 4)),
                          (tk.dtw_tile_stripe_pairs, (40, 128, 4))):
        layouts = {id(f) for k, _, f in calls if k is kernel}
        assert len(layouts) == 1
        assert tuple(next(f for k, _, f in calls if k is kernel).shape) == shape
    calls.clear()
    forced = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=8, stripe=True, device="cpu")
    assert {k for k, _, _ in calls} == {tk.dtw_tile_stripe_pairs}
    np.testing.assert_array_equal(got, forced)


def test_widen_class_fns_equal_jax():
    rng = np.random.default_rng(21)
    for trial in range(12):
        ti, nT = 8, int(rng.integers(2, 9))
        K = nT * ti - int(rng.integers(0, ti))
        Lp = 256 if trial % 2 else 1024
        lens_p = np.ones(nT * ti, np.int32)
        lens_p[:K] = np.sort(rng.integers(2, Lp + 1, K))
        band, auto = int(rng.integers(0, 40)), bool(trial % 3)
        pairs = [(i, j) for i in range(nT) for j in range(i, nT)]
        t_fn = tps.make_tile_stripe_class_fn(lens_p, nT, ti, Lp, band, auto, K)
        j_fn = jps.make_tile_stripe_class_fn(lens_p, nT, ti, Lp, band, auto, K,
                                             level_fn=jps._ws_level)
        t_cls, j_cls = {}, {}
        for p in pairs:
            assert t_fn(*p) == j_fn(*p)
            t_cls.setdefault(t_fn(*p), []).append(p)
            j_cls.setdefault(j_fn(*p), []).append(p)
        tps._merge_thin_classes(t_cls)
        jps._merge_thin_classes(j_cls)
        assert t_cls == j_cls


@pytest.mark.parametrize("band,auto", [(None, True), (16, True), (16, False), (4, True)])
def test_enumerate_pair_blocks_equal_jax(band, auto):
    rng = np.random.default_rng(22)
    lens = rng.integers(3, 1100, 300).astype(np.int32)
    got = list(tps.enumerate_pair_blocks(lens, 2000, 32, 1100, band=band, auto_widen=auto))
    want = list(jps.enumerate_pair_blocks(lens, 2000, 32, 1100, band=band, auto_widen=auto))
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        np.testing.assert_array_equal(g[3], w[3])
        np.testing.assert_array_equal(g[4], w[4])


@pytest.mark.parametrize(
    "route,auto,metric",
    [("lane", True, "euclidean"), ("stripe", True, "euclidean"), ("lane", False, "euclidean"),
     ("lane", True, "cosine")],
)
def test_widen_tiled_routes_match_jax_per_pair(route, auto, metric):
    feats, lens = _case(23)
    cfg, jcfg = _cfgs(band=4, band_mode="widen", auto_widen_band=auto, normalize="path_len",
                      metric=metric)
    stats = {}
    got = tps.all_pairs_distances_tiled(feats, lens, cfg, ti=8, stats=stats,
                                        lane=route == "lane", stripe=route == "stripe",
                                        device="cpu")
    assert stats["route"] == "widen"
    want = jps.all_pairs_distances(feats, lens, jcfg, tiled=False)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.diag(got), 0.0)
    np.testing.assert_array_equal(got, got.T)
    if not auto:
        assert np.isinf(got).any()
    # The default (per-class K4/K5) agrees with either forced kernel.
    default = tps.all_pairs_distances(feats, lens, cfg, device="cpu")
    np.testing.assert_allclose(default, got, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize(
    "kw",
    [
        dict(band=4, band_mode="widen", normalize="path_len"),
        dict(band=4, band_mode="widen", auto_widen_band=False, normalize="none"),
        dict(band=None, normalize="path_len", metric="cosine"),
        dict(band=3, band_mode="diag", normalize="path_len"),
    ],
)
def test_per_pair_matches_jax_per_pair(kw):
    feats, lens = _case(24, K=26, L=40, lo=3)
    cfg, jcfg = _cfgs(**kw)
    stats = {}
    before = (tk.dtw_batch_pallas.launches, tk._dtw_batch_stripe.launches)
    got = tps.all_pairs_distances(feats, lens, cfg, tiled=False, bucket_step=8, stats=stats,
                                  device="cpu")
    assert (tk.dtw_batch_pallas.launches, tk._dtw_batch_stripe.launches) == before
    want = jps.all_pairs_distances(feats, lens, jcfg, tiled=False, bucket_step=8)
    assert stats["route"] == "per_pair" and stats["blocks"] > 1
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, got.T)
    np.testing.assert_array_equal(np.diag(got), 0.0)


def test_per_pair_stripe_buckets_match_tiled_and_jax():
    # Long units: buckets of 512-576 frames with small length differences
    # take the stripe route (K7's twin) on the per-pair path; D equals the
    # tiled widen D and the JAX per-pair D.
    rng = np.random.default_rng(25)
    K, L, d = 10, 576, 3
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    lens = rng.integers(500, 541, K).astype(np.int32)
    cfg, jcfg = _cfgs(band=8, band_mode="widen", normalize="path_len")
    blocks = list(tps.enumerate_pair_blocks(lens, 64, 32, L, band=8))
    assert any(tk.stripe_width(bb, 8, True, mld) for _, bb, mld, _, _ in blocks)
    got = tps.all_pairs_distances(feats, lens, cfg, tiled=False, device="cpu")
    tiled = tps.all_pairs_distances(feats, lens, cfg, device="cpu")
    want = jps.all_pairs_distances(feats, lens, jcfg, tiled=False)
    np.testing.assert_allclose(got, tiled, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_per_pair_unported_options_raise(tmp_path):
    feats, lens = _case(26, K=4)
    cfg = DTWConfig(band=4, band_mode="widen")
    # Block persistence, known= reuse and retries run on the per-pair route
    # (tests/test_torch_update.py holds them against full recomputes).
    want = tps.all_pairs_distances(feats, lens, cfg, tiled=False, device="cpu")
    for kw in (dict(block_dir=tmp_path / "blocks"), dict(known=(2, want[:2, :2])),
               dict(max_retries=0)):
        got = tps.all_pairs_distances(feats, lens, cfg, tiled=False, **kw, device="cpu")
        np.testing.assert_array_equal(got, want)
    # An unbanded bucket past K6's 1024 frames raised before K8: it runs,
    # with the JAX package's D.
    long_feats = np.random.default_rng(26).normal(0, 1, (3, 1100, 2)).astype(np.float32)
    long_lens = np.array([1100, 1090, 60], np.int32)
    got = tps.all_pairs_distances(long_feats, long_lens, DTWConfig(band=None), tiled=False,
                                  device="cpu")
    want = jps.all_pairs_distances(long_feats, long_lens, JCfg(band=None), tiled=False)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(NotImplementedError, match="float32"):
        tps.all_pairs_distances(feats, lens, DTWConfig(band=4, dtype="bfloat16"), tiled=False,
                                device="cpu")
    with pytest.raises(ValueError, match="widen kernel"):
        tps.all_pairs_distances_tiled(feats, lens, DTWConfig(band=4, band_mode="diag"), lane=True,
                                      device="cpu")
    with pytest.raises(ValueError, match="widen kernel"):
        tps.all_pairs_distances_tiled(feats, lens, cfg, lane=True, stripe=True, device="cpu")
