"""Incremental update in the port: discover(update_from=...), the
schedulers' known= / new_from reuse, block persistence and retries.

An update over corpus A+B must equal a full run over A+B with the same
frozen embedding, and the JAX package's own update of the same index.  The
fixture is tests/test_update.py's: 8 planted clips indexed, 4 added.
Tolerances: the port against the JAX package as the goldens (D at rtol
1e-4 / atol 1e-5, partition exact); the port against itself on the same
kernels (a full run, a resumed run) exact or, where the boundary tile's
pairs run in another orientation, to 1e-6."""

import json
import shutil

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.config import PipelineConfig as JCfg
from audio_pattern_discovery_tpu.pipeline import discover as jdiscover
from audio_pattern_discovery_tpu_torch.config import DTWConfig, PipelineConfig
from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as tps
from audio_pattern_discovery_tpu_torch.pipeline import discover
from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

torch.set_num_threads(1)


def _cfg(cls=PipelineConfig, embed: str | None = None) -> PipelineConfig:
    """tests/test_update.py's config; ``embed`` "ae" or "pca" turns the
    embedder (and its checkpoint) on."""
    cfg = cls()
    cfg.spectrogram.sample_rate = 16_000
    cfg.spectrogram.win_length = 256
    cfg.spectrogram.hop_length = 128
    cfg.spectrogram.max_bins = 64
    cfg.segmentation.threshold_db = -25.0
    cfg.segmentation.min_len_frames = 6
    cfg.segmentation.merge_gap_frames = 3
    cfg.autoencoder.enabled = embed is not None
    cfg.autoencoder.method = embed or "ae"
    cfg.autoencoder.epochs = 6
    cfg.autoencoder.hidden_dims = (64,)
    cfg.autoencoder.latent_dim = 8
    cfg.autoencoder.checkpoint = embed is not None
    cfg.dtw.max_seq_len = 64
    cfg.dtw.pair_batch = 128
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    cfg.output.write_snippets = False
    return cfg


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    src = tmp_path_factory.mktemp("update") / "src"
    make_corpus(src, n_clips=12, n_motifs=3, occurrences_per_clip=2, clip_seconds=2.0,
                sample_rate=16_000, seed=7)
    return sorted(src.glob("*.wav"))


def _grow(tmp_path, wavs, n_initial):
    """The first n_initial clips in a fresh corpus dir, and the later ones
    (alphabetically last, so an update's clip order is the full run's)."""
    grow = tmp_path / "corpus"
    grow.mkdir()
    for p in wavs[:n_initial]:
        shutil.copy(p, grow / p.name)
    return grow, wavs[n_initial:]


def _add(grow, later):
    for p in later:
        shutil.copy(p, grow / p.name)


def _partition(labels):
    groups = {}
    for i, lab in enumerate(labels):
        groups.setdefault(int(lab), []).append(i)
    return sorted(tuple(g) for g in groups.values())


@pytest.mark.parametrize("embed", [None, "pca"], ids=["raw", "pca"])
def test_port_updates_jax_index_as_jax_does(tmp_path, source, embed):
    # An index built by the JAX package (raw features, or PCA with the
    # shared pca_state.npz) grown by the port and by the JAX package.
    grow, later = _grow(tmp_path, source, 8)
    out = tmp_path / "jax_index"
    first = jdiscover(grow, _cfg(JCfg, embed), out_dir=out)
    _add(grow, later)
    got = discover(grow, _cfg(PipelineConfig, embed), out_dir=tmp_path / "port_up",
                   update_from=out, device="cpu")
    want = jdiscover(grow, _cfg(JCfg, embed), out_dir=tmp_path / "jax_up", update_from=out)
    k_old, K = len(first.segments), len(want.segments)
    assert len(got.segments) == K > k_old
    np.testing.assert_allclose(got.distance_matrix, want.distance_matrix, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.distance_matrix[:k_old, :k_old], first.distance_matrix)
    assert _partition(got.labels) == _partition(want.labels)
    reused = k_old * (k_old - 1) // 2
    assert got.counters.counts["dtw_pairs_reused"] == reused
    assert got.counters.counts["dtw_pairs"] == K * (K - 1) // 2 - reused
    # The port's out_dir is itself an index the JAX package can grow.
    state = json.loads((tmp_path / "port_up" / "state.json").read_text())
    assert state == json.loads((tmp_path / "jax_up" / "state.json").read_text()) | {
        "clip_paths": state["clip_paths"]}
    if embed == "pca":
        assert (tmp_path / "port_up" / "ae_ckpt" / "pca_state.npz").is_file()


def test_ae_update_equals_full_run_from_restored_checkpoint(tmp_path, source):
    grow, later = _grow(tmp_path, source, 8)
    cfg = _cfg(embed="ae")
    out = tmp_path / "out"
    first = discover(grow, cfg, out_dir=out, device="cpu")
    assert first.ae_losses
    _add(grow, later)
    up = discover(grow, cfg, out_dir=tmp_path / "out_up", update_from=out, device="cpu")
    assert not up.ae_losses                      # frozen, never retrained
    out_full = tmp_path / "out_full"
    shutil.copytree(out / "ae_ckpt", out_full / "ae_ckpt")
    full = discover(grow, cfg, out_dir=out_full, device="cpu")
    np.testing.assert_allclose(up.distance_matrix, full.distance_matrix, rtol=0, atol=1e-6)
    assert _partition(up.labels) == _partition(full.labels)
    # Chained updates keep working: the update run re-saved the checkpoint.
    assert (tmp_path / "out_up" / "ae_ckpt" / "ae_state.npz").is_file()


@pytest.mark.parametrize("case", ["feature_drift", "band_mode", "removed_clip", "no_state",
                                  "ae_without_checkpoint"])
def test_update_refusals(tmp_path, source, case):
    grow, later = _grow(tmp_path, source, 6 if case != "removed_clip" else 8)
    cfg = _cfg(embed="ae" if case == "ae_without_checkpoint" else None)
    if case == "band_mode":
        cfg.dtw.band, cfg.dtw.band_mode = 8, "diag"
    if case == "ae_without_checkpoint":
        cfg.autoencoder.checkpoint = False
        cfg.autoencoder.epochs = 1
    out = tmp_path / "out"
    if case != "no_state":
        discover(grow, cfg, out_dir=out, device="cpu")
    _add(grow, later[:2])
    run = cfg
    if case == "feature_drift":
        run = _cfg()
        run.dtw.band = 8
        match = "feature-affecting"
    elif case == "band_mode":
        run = _cfg()
        run.dtw.band, run.dtw.band_mode = 8, "widen"
        match = "band_mode='diag'"
    elif case == "removed_clip":
        next(iter(sorted(grow.glob("*.wav")))).unlink()
        match = "no longer under"
    elif case == "no_state":
        match = "state.json"
    else:
        match = "no checkpoint"
    error = FileNotFoundError if case == "no_state" else ValueError
    with pytest.raises(error, match=match):
        discover(grow, run, update_from=out, device="cpu")
    if case == "feature_drift":
        # Downstream-only knobs (the clustering cut) may change freely.
        recut = _cfg()
        recut.cluster.linkage = "complete"
        discover(grow, recut, update_from=out, device="cpu")


def _jobs():
    """(name, L, cfg, old length range, new length range): each tiled route
    with the new sequences shorter than the old, so the grouped sort puts a
    short new tile J against long old tiles I."""
    return [
        ("diag", 32, DTWConfig(band=2, band_mode="diag", normalize="path_len"), (16, 32), (2, 9)),
        ("tile", 32, DTWConfig(band=None, normalize="path_len"), (16, 32), (2, 9)),
        ("full", 300, DTWConfig(band=None, normalize="path_len"), (200, 300), (40, 90)),
        ("widen", 32, DTWConfig(band=2, band_mode="widen", normalize="path_len"), (16, 32),
         (2, 9)),
    ]


def _job(seed, L, old, new, K=22, k_old=14, d=3):
    rng = np.random.default_rng(seed)
    lens = np.concatenate([rng.integers(old[0], old[1] + 1, k_old),
                           rng.integers(new[0], new[1] + 1, K - k_old)]).astype(np.int32)
    feats = rng.normal(size=(K, L, d)).astype(np.float32)
    for k in range(K):
        feats[k, lens[k]:] = 0.0
    return feats, lens


@pytest.mark.parametrize("route,L,cfg,old,new", _jobs(), ids=[f"{j[0]}_route" for j in _jobs()])
def test_known_matches_full_recompute_with_out_of_order_tiles(route, L, cfg, old, new):
    feats, lens = _job(7, L, old, new)
    k_old = 14
    full = tps.all_pairs_distances(feats, lens, cfg, device="cpu")
    D_old = full[:k_old, :k_old].copy()
    stats: dict = {}
    got = tps.all_pairs_distances_tiled(feats, lens, cfg, device="cpu", ti=4,
                                        known=(k_old, D_old), stats=stats)
    assert stats["route"] == route
    # 4 old tiles, a boundary tile (2 old + 2 new), 1 new tile: 15 of the
    # 21 tile-pairs touch a new sequence.
    assert stats["tile_programs"] == 15
    assert stats["pairs"] == 22 * 21 // 2 - k_old * (k_old - 1) // 2
    # The boundary tile recomputes its old x old pairs (on the diag route
    # in another orientation than the sorted full run: a few ulps).
    np.testing.assert_allclose(got, full, rtol=0, atol=1e-6)
    pp_stats: dict = {}
    per_pair = tps.all_pairs_distances(feats, lens, cfg, device="cpu", tiled=False,
                                       known=(k_old, D_old), stats=pp_stats)
    np.testing.assert_allclose(per_pair, full, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(per_pair[:k_old, :k_old], D_old)
    assert pp_stats["pairs"] == stats["pairs"]


def test_diag_route_puts_the_longer_tile_on_rows():
    # Under known= a new tile can be shorter than an old one; the diag
    # route orients each tile-pair long side on rows, so its classes stay
    # those of the band (a short side on rows widens them by the ratio).
    cfg = DTWConfig(band=2, band_mode="diag", normalize="path_len")
    feats, lens = _job(3, 32, (28, 32), (2, 3))
    calls = []
    real = tps.dtw_tile_lane_diag_pairs

    def spy(feats_p, lens_p, rep, ii, jj, **kw):
        calls.append((ii.numpy().copy(), jj.numpy().copy(), kw["wv_max"]))
        return real(feats_p, lens_p, rep, ii, jj, **kw)

    tps.dtw_tile_lane_diag_pairs = spy
    try:
        tps.all_pairs_distances_tiled(feats, lens, cfg, device="cpu", ti=4,
                                      known=(14, np.zeros((14, 14), np.float32)))
    finally:
        tps.dtw_tile_lane_diag_pairs = real
    rows = [(int(i), int(j)) for ii, jj, _ in calls for i, j in zip(ii, jj)]
    # Tiles 0-3 old (28-32 frames), tile 4 the boundary, tile 5 new (2-3).
    assert (5, 0) not in rows and (0, 5) in rows
    perm = np.concatenate([np.argsort(lens[:14], kind="stable"),
                           14 + np.argsort(lens[14:], kind="stable")])
    lens_p = np.ones(24, np.int32)
    lens_p[:22] = lens[perm]
    pair_class = tps.make_tile_lane_diag_class_fn(lens_p, 6, 4, 128, 2, 22)
    assert pair_class(0, 5)[1] < pair_class(5, 0)[1]


@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "per_pair"])
def test_block_resume_dispatches_nothing(tmp_path, monkeypatch, tiled):
    cfg = DTWConfig(band=None, normalize="path_len")
    feats, lens = _job(11, 32, (16, 32), (2, 9))
    name = "dtw_tile_pairs" if tiled else "dtw_batch_pallas"
    real, calls = getattr(tps, name), []

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tps, name, counting)
    runs = []
    for _ in range(2):
        stats: dict = {}
        n0 = len(calls)
        D = tps.all_pairs_distances(feats, lens, cfg, device="cpu", tiled=tiled,
                                    block_dir=tmp_path / "blocks", stats=stats)
        runs.append((D, len(calls) - n0, stats))
    (D1, n1, s1), (D2, n2, s2) = runs
    assert n1 == s1["blocks"] > 0 and s1["blocks_resumed"] == 0
    assert n2 == 0 and s2["blocks_resumed"] == s2["blocks"] == s1["blocks"]
    np.testing.assert_array_equal(D1, D2)
    # Another config never reads those blocks.
    n0 = len(calls)
    tps.all_pairs_distances(feats, lens, DTWConfig(band=None, metric="sqeuclidean"),
                            device="cpu", tiled=tiled, block_dir=tmp_path / "blocks")
    assert len(calls) - n0 == s1["blocks"]


def test_checkpoint_blocks_resume_through_discover(tmp_path, source):
    grow, _ = _grow(tmp_path, source, 6)
    cfg = _cfg()
    cfg.parallel.checkpoint_blocks = True
    out = tmp_path / "out"
    first = discover(grow, cfg, out_dir=out, device="cpu")
    blocks = sorted((out / cfg.parallel.block_dir).glob("*.npz"))
    assert blocks
    again = discover(grow, cfg, out_dir=out, device="cpu")
    np.testing.assert_array_equal(first.distance_matrix, again.distance_matrix)
    assert sorted((out / cfg.parallel.block_dir).glob("*.npz")) == blocks


@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "per_pair"])
def test_a_dispatch_that_fails_once_is_retried(monkeypatch, tiled):
    cfg = DTWConfig(band=None, normalize="path_len")
    feats, lens = _job(13, 32, (16, 32), (2, 9))
    want = tps.all_pairs_distances(feats, lens, cfg, device="cpu", tiled=tiled)
    name = "dtw_tile_pairs" if tiled else "dtw_batch_pallas"
    real = getattr(tps, name)

    def flaky(*args, **kw):
        if not failed:
            failed.append(1)
            raise RuntimeError("transient launch failure")
        return real(*args, **kw)

    monkeypatch.setattr(tps, name, flaky)
    failed: list = []
    got = tps.all_pairs_distances(feats, lens, cfg, device="cpu", tiled=tiled)
    assert failed
    np.testing.assert_array_equal(got, want)
    failed.clear()
    with pytest.raises(RuntimeError, match="transient"):
        tps.all_pairs_distances(feats, lens, cfg, device="cpu", tiled=tiled, max_retries=0)


def test_known_shape_is_checked():
    feats, lens = _job(5, 32, (16, 32), (2, 9))
    with pytest.raises(ValueError, match="D_old shape"):
        tps.all_pairs_distances(feats, lens, DTWConfig(band=None), device="cpu",
                                known=(14, np.zeros((13, 13), np.float32)))
