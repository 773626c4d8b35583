"""The port's temporal-context stacking (ops/context.py) and mu-law upload
codec (ops/spectrogram.py) against the JAX package, and discover() with
each against the JAX package's discover() on the same corpus.

Tolerances: the stacking is a gather, so bitwise; the mu-law encode is the
same NumPy code, so bitwise; the decode is one float32 pow per sample, to
atol 1e-6; discover() is held as the goldens are (D at rtol 1e-4 / atol
1e-5, cluster partition exact)."""

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.config import PipelineConfig as JCfg
from audio_pattern_discovery_tpu.ops import context as jctx
from audio_pattern_discovery_tpu.ops import spectrogram as jsp
from audio_pattern_discovery_tpu.pipeline import discover as jdiscover
from audio_pattern_discovery_tpu_torch.config import PipelineConfig
from audio_pattern_discovery_tpu_torch.ops import context as tctx
from audio_pattern_discovery_tpu_torch.ops import spectrogram as tsp
from audio_pattern_discovery_tpu_torch.pipeline import discover
from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

torch.set_num_threads(1)


def _segments(seed, K=6, L=12, d=5):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, L + 1, K).astype(np.int32)
    lens[0] = L
    frames = rng.normal(size=(K, L, d)).astype(np.float32)
    for k in range(K):
        frames[k, lens[k]:] = 0.0
    return frames, lens


@pytest.mark.parametrize("k", [0, 1, 2])
def test_stacking_matches_jax(k):
    frames, lens = _segments(k)
    want = jctx.stack_context_host(frames, lens, k)
    np.testing.assert_array_equal(tctx.stack_context_host(frames, lens, k), want)
    np.testing.assert_array_equal(
        tctx.stack_context_device(torch.from_numpy(frames), lens, k).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jctx.stack_context_device(frames, lens, k)), want)
    np.testing.assert_array_equal(tctx.flat_context(frames, lens, k),
                                  jctx.flat_context(frames, lens, k))
    np.testing.assert_array_equal(tctx.stack_context_frames(frames[0], k),
                                  jctx.stack_context_frames(frames[0], k))
    if k:
        assert want.shape == (*frames.shape[:2], (2 * k + 1) * frames.shape[2])


def test_mulaw_codec_matches_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 4096), [-1.0, 0.0, 1.0, 1e-9, -1e-9]])
    x = x.astype(np.float32)
    q = tsp.mulaw_encode_host(x)
    assert q.dtype == np.int8
    np.testing.assert_array_equal(q, jsp.mulaw_encode_host(x))
    every = np.arange(-127, 128, dtype=np.int8)
    got = tsp.mulaw_decode_device(torch.from_numpy(every)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsp.mulaw_decode_device(every)), rtol=0,
                               atol=1e-6)
    # decode_signals: the peak multiplies the decoded codes back.
    scales = torch.tensor([2.0, 0.5])
    sig = tsp.decode_signals(torch.from_numpy(np.stack([every, every])), scales)
    np.testing.assert_allclose(sig.numpy(), np.stack([got * 2.0, got * 0.5]), rtol=1e-6)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("ctx") / "corpus"
    make_corpus(d, n_clips=8, n_motifs=3, occurrences_per_clip=2, clip_seconds=2.0,
                sample_rate=16_000, seed=7)
    return d


def _cfg(cls, overrides):
    cfg = cls()
    cfg.spectrogram.sample_rate = 16_000
    cfg.spectrogram.win_length = 256
    cfg.spectrogram.hop_length = 128
    cfg.spectrogram.max_bins = 64
    cfg.segmentation.threshold_db = -25.0
    cfg.segmentation.min_len_frames = 6
    cfg.segmentation.merge_gap_frames = 3
    cfg.autoencoder.method = "pca"
    cfg.autoencoder.latent_dim = 8
    cfg.dtw.max_seq_len = 64
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    cfg.output.write_snippets = False
    return cfg.override(overrides)


def _partition(labels):
    groups = {}
    for i, lab in enumerate(labels):
        groups.setdefault(int(lab), []).append(i)
    return sorted(tuple(g) for g in groups.values())


@pytest.mark.parametrize("overrides", [
    {"autoencoder.context_frames": 2},
    {"spectrogram.upload_codec": "mulaw8"},
    {"spectrogram.upload_codec": "mulaw8", "spectrogram.normalize_signal": False},
], ids=["context2", "mulaw8", "mulaw8-unnormalized"])
def test_discover_matches_jax(corpus, overrides):
    got = discover(corpus, _cfg(PipelineConfig, overrides), device="cpu")
    want = jdiscover(corpus, _cfg(JCfg, overrides))
    np.testing.assert_allclose(got.distance_matrix, want.distance_matrix, rtol=1e-4, atol=1e-5)
    assert _partition(got.labels) == _partition(want.labels)
    if "autoencoder.context_frames" in overrides:
        assert "context_stack" in got.counters.timings_s
    assert got.counters.counts["embedding_fit_device"] == 1
    # The option changes the result: it is not ignored.
    plain = discover(corpus, _cfg(PipelineConfig, {}), device="cpu")
    assert np.abs(plain.distance_matrix - got.distance_matrix).max() > 1e-4
