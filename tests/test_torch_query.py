"""Query-by-example in the port (query.py, the CLI's --query and --top-k)
against the JAX package's report for the same index.

The fixture is tests/test_query.py's: 10 planted clips indexed by the JAX
package, clip 10 held out as the query.  The reports must agree key for
key: the same ranking, distances to rtol 1e-4 (the goldens' tolerance)."""

import json
import shutil

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.config import PipelineConfig as JCfg
from audio_pattern_discovery_tpu.pipeline import discover as jdiscover
from audio_pattern_discovery_tpu.query import query_corpus as jquery
from audio_pattern_discovery_tpu_torch.cli import main as cli_main
from audio_pattern_discovery_tpu_torch.config import PipelineConfig
from audio_pattern_discovery_tpu_torch.io.wavio import write_wav
from audio_pattern_discovery_tpu_torch.query import query_corpus
from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

torch.set_num_threads(1)


def _cfg(cls=PipelineConfig, embed: str | None = None):
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
    cfg.autoencoder.latent_dim = 8
    cfg.autoencoder.checkpoint = embed is not None
    cfg.dtw.max_seq_len = 64
    cfg.dtw.pair_batch = 128
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    cfg.output.write_snippets = False
    return cfg


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    """{embed: (index out_dir, query wav)}: 10 clips indexed by the JAX
    package with raw features and with PCA."""
    root = tmp_path_factory.mktemp("query")
    make_corpus(root / "src", n_clips=11, n_motifs=3, occurrences_per_clip=2,
                clip_seconds=2.0, sample_rate=16_000, seed=7)
    wavs = sorted((root / "src").glob("*.wav"))
    corpus = root / "corpus"
    corpus.mkdir()
    for p in wavs[:10]:
        shutil.copy(p, corpus / p.name)
    out = {}
    for embed in (None, "pca"):
        d = root / f"index_{embed}"
        jdiscover(corpus, _cfg(JCfg, embed), out_dir=d)
        out[embed] = (d, wavs[10])
    return out


@pytest.mark.parametrize("embed", [None, "pca"], ids=["raw", "pca"])
def test_query_report_matches_jax(indexed, embed):
    index, qwav = indexed[embed]
    got = query_corpus(index, [qwav], _cfg(PipelineConfig, embed), top_k=5, device="cpu")
    want = jquery(index, [qwav], _cfg(JCfg, embed), top_k=5)
    json.dumps(got)
    assert got["n_query_segments"] >= 1
    # The port's reply carries the query's stage seconds and counts besides
    # the reference's keys.
    stages = {"index_load", "ingest", "spectrogram", "segmentation", "embedding", "dtw"}
    assert set(got.pop("timings_s")) == stages
    assert got.pop("counts")["query_segments"] == got["n_query_segments"]
    assert {k: v for k, v in got.items() if k != "queries"} == {
        k: v for k, v in want.items() if k != "queries"}
    for q, w in zip(got["queries"], want["queries"], strict=True):
        assert {k: v for k, v in q.items() if k != "matches"} == {
            k: v for k, v in w.items() if k != "matches"}
        assert [m["segment"] for m in q["matches"]] == [m["segment"] for m in w["matches"]]
        np.testing.assert_allclose([m["distance"] for m in q["matches"]],
                                   [m["distance"] for m in w["matches"]], rtol=1e-4, atol=1e-5)
        for m, n in zip(q["matches"], w["matches"]):
            assert {k: v for k, v in m.items() if k != "distance"} == {
                k: v for k, v in n.items() if k != "distance"}


def test_query_refuses_stale_distances(indexed, tmp_path):
    # The spot check catches a distance matrix that no longer matches the
    # recomputed features (here: corrupted on disk).
    index, qwav = indexed[None]
    stale = tmp_path / "index"
    shutil.copytree(index, stale)
    np.save(stale / "distance_matrix.npy", np.load(index / "distance_matrix.npy") * 3.0 + 1.0)
    with pytest.raises(ValueError, match="drifted"):
        query_corpus(stale, [qwav], _cfg(), device="cpu")


def test_query_refuses_other_sample_rate_and_missing_inputs(indexed, tmp_path):
    index, qwav = indexed[None]
    bad = tmp_path / "q44k.wav"
    rng = np.random.default_rng(0)
    write_wav(bad, rng.uniform(-0.5, 0.5, 44_100).astype(np.float32), 44_100)
    with pytest.raises(ValueError, match="sample rate"):
        query_corpus(index, [bad], _cfg(), device="cpu")
    with pytest.raises(FileNotFoundError, match="query wav"):
        query_corpus(index, [tmp_path / "nope.wav"], _cfg(), device="cpu")
    with pytest.raises(FileNotFoundError, match="state.json"):
        query_corpus(tmp_path / "empty", [qwav], _cfg(), device="cpu")
    drifted = _cfg()
    drifted.dtw.band = 8
    with pytest.raises(ValueError, match="feature-affecting"):
        query_corpus(index, [qwav], drifted, device="cpu")


def test_cli_query_and_top_k(indexed, tmp_path, capsys):
    index, qwav = indexed[None]
    cfg_path = tmp_path / "cfg.json"
    _cfg().to_json(cfg_path)
    for flags, k in (([], 10), (["--top-k", "3"], 3)):
        assert cli_main(["--query", str(qwav), "-o", str(index), "-c", str(cfg_path),
                         "--device", "cpu", *flags]) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["queries"] and all(len(q["matches"]) == k for q in report["queries"])


@pytest.mark.parametrize("argv,message", [
    (["somedir", "--query", "q.wav"], "--query cannot be combined"),
    (["--query", "q.wav", "--update"], "--query cannot be combined"),
    (["somedir", "--serve", "apd.sock"], "--serve runs a resident worker"),
    (["--serve", "apd.sock", "--query", "q.wav"], "--serve runs a resident worker"),
])
def test_cli_conflicts_rejected(tmp_path, capsys, argv, message):
    with pytest.raises(SystemExit):
        cli_main([*argv, "-o", str(tmp_path), "--device", "cpu"])
    assert message in capsys.readouterr().err
