"""Query-by-example over an indexed corpus: rank the segments of a prior
``discover`` run by DTW distance to each segment of new WAV(s), and report
their clusters.

Port of ``audio_pattern_discovery_tpu/query.py``.  The prior out_dir's
``state.json`` and ``distance_matrix.npy`` identify the corpus and its
segmentation; the linear stages re-run over corpus + query clips with the
embedder frozen from the prior checkpoint (the update contract of
``pipeline.discover``), and the pair scheduler's ``known=`` path computes
only the query x corpus distances, on the job's device (the card unless the
caller asks for the CPU).  A spot check recomputes a few stored corpus pairs
from the fresh features and compares them with the stored matrix, so silent
feature drift fails loudly instead of returning wrong rankings.  The report
is the reference's JSON, key for key.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from audio_pattern_discovery_tpu_torch.config import DTWConfig, PipelineConfig
from audio_pattern_discovery_tpu_torch.io.corpus import StreamingCorpus
from audio_pattern_discovery_tpu_torch.ops.dtw import dtw_batch
from audio_pattern_discovery_tpu_torch.utils.device import resolve_device
from audio_pattern_discovery_tpu_torch.utils.logging import StageCounters, get_logger


def spot_check_prior_distances(
    features: torch.Tensor,    # [K, L, d] on the job's device
    lengths: np.ndarray,
    cfg: DTWConfig,
    D_old: np.ndarray,
    k_old: int,
    n_pairs: int = 8,
    rtol: float = 5e-3,
    atol: float = 5e-3,
) -> None:
    """Recompute a few prior-pair distances from freshly derived features
    with the plain ``ops/dtw.dtw_batch``, on the features' device, and
    compare them with the stored matrix (the tolerance covers the plain
    path against the tile kernels).  Raises ValueError on drift."""
    if k_old < 2:
        return
    rng = np.random.default_rng(0)
    ii = rng.integers(0, k_old, n_pairs).astype(np.int64)
    jj = rng.integers(0, k_old - 1, n_pairs).astype(np.int64)
    jj = np.where(jj >= ii, jj + 1, jj)  # i != j
    lengths = np.asarray(lengths)
    dev = features.device
    got = dtw_batch(
        features[torch.from_numpy(ii).to(dev)], features[torch.from_numpy(jj).to(dev)],
        torch.from_numpy(lengths[ii].astype(np.int64)).to(dev),
        torch.from_numpy(lengths[jj].astype(np.int64)).to(dev),
        metric=cfg.metric,
        band=cfg.band,
        auto_widen=cfg.auto_widen_band,
        normalize=cfg.normalize,
        band_mode=cfg.band_mode,
    ).cpu().numpy()
    want = D_old[ii, jj]
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        worst = float(np.abs(got - want).max())
        hint = ""
        if cfg.band is not None:
            hint = (
                "  If the index predates round 5 and was built under the "
                "old banded default, its distances used "
                "dtw.band_mode=widen — try -s dtw.band_mode=widen."
            )
        raise ValueError(
            f"stored distances drifted from recomputed features (max "
            f"|delta| = {worst:.3g} over {n_pairs} spot pairs) — were corpus "
            f"files or the environment modified?  Run a full discovery.{hint}"
        )


def query_corpus(
    prior_out_dir: str | Path,
    query_wavs: list[str | Path],
    config: PipelineConfig | None = None,
    top_k: int = 10,
    logger=None,
    device: torch.device | str = "cuda",
) -> dict:
    """Rank a prior run's corpus segments by DTW distance to each segment
    of the query WAV(s) on ``device`` (the card unless the caller asks for
    the CPU).  Returns a JSON-serializable report, with the query's stage
    seconds and counts (``timings_s``: index_load, ingest, spectrogram,
    segmentation, embedding, dtw; ``counts``)."""
    from audio_pattern_discovery_tpu_torch.models.autoencoder import encode_frames
    from audio_pattern_discovery_tpu_torch.models.pca import encode_pca
    from audio_pattern_discovery_tpu_torch.ops.context import stack_context_device
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances
    from audio_pattern_discovery_tpu_torch.pipeline import (
        _check_band_mode,
        _feature_fingerprint,
        _has_embedder_checkpoint,
        _load_update_state,
        _prepare_corpus,
        _validate_prior_segments,
    )
    from audio_pattern_discovery_tpu_torch.utils import checkpoint as ckpt

    cfg = (config or PipelineConfig()).validate()
    device = resolve_device(device)
    log = logger or get_logger()
    counters = StageCounters()
    prior = Path(prior_out_dir)
    with counters.time_stage("index_load"):
        state, D_old = _load_update_state(prior)
    _check_band_mode(state, cfg, "query")
    if state["feature_fingerprint"] != _feature_fingerprint(cfg):
        raise ValueError(
            "query: a feature-affecting config section differs from the "
            "indexed run's — distances would not be comparable"
        )
    ae = cfg.autoencoder
    ckpt_dir = prior / ae.checkpoint_dir
    if ae.enabled and not _has_embedder_checkpoint(cfg, ckpt_dir):
        raise ValueError(
            "query: the embedding is enabled but the indexed run "
            "saved no checkpoint (rerun it with "
            "-s autoencoder.checkpoint=true)"
        )

    stored = [Path(p) for p in state["clip_paths"]]
    qpaths = [Path(p) for p in query_wavs]
    for p in qpaths:
        if not p.exists():
            raise FileNotFoundError(f"query wav not found: {p}")
    with counters.time_stage("ingest"):
        stream = StreamingCorpus(
            stored[0].parent,
            paths=stored + qpaths,
            resample_to=(
                cfg.spectrogram.sample_rate
                if cfg.spectrogram.resample == "auto"
                else None
            ),
        )
    counters.add("clips", len(stream))

    # win/hop are in samples: a query at another rate than the indexed
    # corpus lands on another time/frequency scale, so it is refused (with
    # resample=auto the stream has already unified the rates).
    corpus_rates = set(int(r) for r in state["sample_rates"])
    bad = [
        f"{p} ({int(r)} Hz)"
        for p, r in zip(qpaths, stream.sample_rates[len(stored):])
        if int(r) not in corpus_rates
    ]
    if bad:
        raise ValueError(
            f"query wav sample rate differs from the indexed corpus "
            f"({sorted(corpus_rates)} Hz): {', '.join(bad)}; re-run with "
            "-s spectrogram.resample=auto (sound against any index whose "
            "clips are already at the analysis rate — resample is excluded "
            "from the feature fingerprint and drift is caught dynamically) "
            "or resample the query wav yourself first"
        )

    # The one linear-stage derivation shared with discover().
    _, _, segments, seg_frames, seg_frames_dev, seg_lengths = _prepare_corpus(
        cfg, stream, counters, log, device
    )
    try:
        k_old = _validate_prior_segments(state, segments)
    except ValueError as e:
        raise ValueError(f"query: {e}") from None
    q_segments = segments[k_old:]
    if not q_segments:
        raise ValueError(
            "query: no segments found in the query wav(s); loosen the "
            "segmentation config or check the recording level"
        )

    counters.add("segments", len(segments))
    counters.add("query_segments", len(q_segments))

    # Context stacking as in discover(): the fingerprint carries
    # context_frames, so a context-built index is queried with the same k.
    # The embedder is restored and run; on the card its kernels are only
    # queued here and finish in "dtw", which ends in D on the host.
    ctx = ae.context_frames if ae.enabled else 0
    with counters.time_stage("embedding"):
        src = stack_context_device(seg_frames_dev, seg_lengths, ctx)
        if ae.enabled and ae.method == "pca":
            pca_state, scaler = ckpt.restore_pca_checkpoint(ckpt_dir)
            features = encode_pca(pca_state, scaler.transform(src))
        elif ae.enabled:
            model, ae_state, scaler = ckpt.restore_ae_checkpoint(
                ckpt_dir, ae, seg_frames.shape[-1] * (2 * ctx + 1), device=device
            )
            if scaler is None:
                raise ValueError("query: the indexed checkpoint has no saved feature scaler")
            features = encode_frames(model, ae_state.params, scaler.transform(src))
        else:
            features = seg_frames_dev
        del src, seg_frames_dev

    with counters.time_stage("dtw"):
        spot_check_prior_distances(features, seg_lengths, cfg.dtw, D_old, k_old)
        D = all_pairs_distances(features, seg_lengths, cfg.dtw, known=(k_old, D_old),
                                device=device)
    log.info(f"query: {len(q_segments)} query segment(s) against {k_old} corpus segments")

    # Cluster ids from the indexed manifest (segments the prior run dropped
    # as noise carry cluster None).
    seg2cluster: dict[int, int] = {}
    manifest_path = prior / cfg.output.manifest_name
    if manifest_path.exists():
        man = json.loads(manifest_path.read_text())
        for c in man.get("clusters", []):
            for m in c["members"]:
                seg2cluster[int(m["segment"])] = int(c["cluster_id"])

    hop = cfg.spectrogram.hop_length
    win = cfg.spectrogram.win_length
    queries = []
    for qi, seg in enumerate(q_segments):
        dists = D[k_old + qi, :k_old]
        order = np.argsort(dists, kind="stable")[: min(top_k, k_old)]
        matches = []
        for m in order:
            ms = tuple(state["segments"][int(m)])
            matches.append(
                {
                    "segment": int(m),
                    "distance": round(float(dists[m]), 6),
                    "cluster": seg2cluster.get(int(m)),
                    "file": state["clip_paths"][ms[0]],
                    "start_sample": ms[1] * hop,
                    "end_sample": (ms[2] - 1) * hop + win,
                }
            )
        clusters = [m["cluster"] for m in matches if m["cluster"] is not None]
        queries.append(
            {
                "file": str(stream.paths[seg.clip]),
                "start_frame": seg.start_frame,
                "end_frame": seg.end_frame,
                "best_cluster": (
                    max(set(clusters), key=clusters.count) if clusters else None
                ),
                "matches": matches,
            }
        )
    return {
        "n_corpus_segments": k_old,
        "n_query_segments": len(q_segments),
        "queries": queries,
        "timings_s": counters.timings_s,
        "counts": counters.counts,
    }
