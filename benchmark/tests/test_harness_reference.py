"""The plain reference against the port's NumPy oracles (imported here, in
the tests, and never by the reference): DTW distances and paths for every
band, the front end's spectra and segments, and the clustering's cut."""

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu_torch.cluster.agglomerative import auto_cut_threshold
from audio_pattern_discovery_tpu_torch.config import PipelineConfig
from audio_pattern_discovery_tpu_torch.ops.segmentation import segment_energy
from audio_pattern_discovery_tpu_torch.oracle.dtw import dtw_oracle, dtw_path_oracle
from audio_pattern_discovery_tpu_torch.oracle.stft import stft_oracle
from benchmark.corpus import make_corpus, read_wav_pcm16
from benchmark.reference import cluster, dtw, frontend

BANDS = [(None, "diag"), (0, "diag"), (2, "diag"), (1, "widen"), (3, "widen")]


@pytest.mark.parametrize("band,mode", BANDS)
@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
def test_dtw_against_the_oracle(band, mode, metric):
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(12, 9, 3)), rng.normal(size=(12, 11, 3))
    la, lb = rng.integers(1, 10, 12), rng.integers(1, 12, 12)
    kw = dict(metric=metric, band=band, band_mode=mode)
    got = dtw.dtw_distances(torch.from_numpy(a), torch.from_numpy(b), la, lb,
                            normalize="path_len", **kw)
    paths = dtw.warping_paths(torch.from_numpy(a), torch.from_numpy(b), la, lb, **kw)
    for k in range(12):
        want = dtw_oracle(a[k, :la[k]], b[k, :lb[k]], normalize="path_len", **kw)
        assert got[k] == pytest.approx(want, rel=1e-12, abs=1e-12)
        if metric == "euclidean":
            assert paths[k] == [tuple(p) for p in dtw_path_oracle(a[k, :la[k]], b[k, :lb[k]],
                                                                  **kw)[1]]
    excess = dtw.path_excess(torch.from_numpy(a), torch.from_numpy(b), la, lb, paths, **kw)
    assert np.all(np.abs(excess) < 1e-12)


def test_bf16_control_moves_the_distances():
    rng = np.random.default_rng(4)
    a, b = torch.from_numpy(rng.normal(size=(16, 20, 16))), torch.from_numpy(
        rng.normal(size=(16, 20, 16)))
    la = lb = np.full(16, 20)
    exact = dtw.dtw_distances(a, b, la, lb)
    low = dtw.dtw_distances(a, b, la, lb, precision="bf16")
    assert 1e-5 < np.max(np.abs(low - exact) / exact) < 1e-2


def test_front_end_against_the_oracles(tmp_path):
    cfg = PipelineConfig().to_dict()
    sp, sg = cfg["spectrogram"], cfg["segmentation"]
    paths = make_corpus(tmp_path, 2, 2, 2, 2.0, (0.25, 0.5), 44100, -30.0, 9)
    segs, frames, lens = frontend.front_end(paths, sp, sg, 256)
    want_segs = []
    for ci, p in enumerate(paths):
        raw, _ = read_wav_pcm16(p)
        x = raw / 32768.0
        spec = stft_oracle(x / np.abs(x).max(), sp["win_length"], sp["hop_length"])
        energy = np.log10(np.maximum(np.mean(10.0 ** spec, axis=1), 1e-10))
        from audio_pattern_discovery_tpu_torch.config import SegmentationConfig

        runs = segment_energy(energy, len(energy), SegmentationConfig(**sg))
        want_segs += [(ci, s, e) for s, e in runs]
        for k, (c, s, e) in enumerate(segs):
            if c == ci:
                np.testing.assert_allclose(frames[k, :lens[k]], spec[s:s + lens[k]], atol=1e-9)
    assert segs == want_segs and len(segs) >= 2


def test_auto_cut_against_the_port():
    rng = np.random.default_rng(5)
    for _ in range(20):
        h = np.sort(rng.gamma(2.0, size=rng.integers(3, 40)))
        Z = np.zeros((len(h), 4))
        Z[:, 2] = h
        assert cluster.auto_cut(h, 0.9, 1.25) == auto_cut_threshold(Z, quantile=0.9,
                                                                    min_rel_gap=1.25)


def test_partition_gap():
    assert cluster.partition_gap(np.array([0, 0, 1, 1]), np.array([5, 5, 2, 2])) == 0
    assert cluster.partition_gap(np.array([0, 0, 1, 1]), np.array([0, 1, 1, 1])) == 4
