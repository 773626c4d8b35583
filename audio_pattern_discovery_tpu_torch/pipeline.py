"""End-to-end discovery pipeline: the public entry point of the port.

Port of ``audio_pattern_discovery_tpu/pipeline.py`` for both embedders (the
trained autoencoder, the default, and PCA) with diag-banded, widen-banded or
unbanded DTW.  A directory of WAV files in, pattern clusters + DTW
alignments out, on a torch ``device`` or a list of them (default: every
card; without one, ``discover()`` raises unless the caller passes
``device="cpu"``).  Over several devices the reference's mesh
(``parallel.data_axis`` x ``parallel.model_axis``, ``parallel/mesh.py``)
splits the spectrogram's clip groups, the AE's minibatches (and, with a
model axis, its layers' outputs) and the DTW's chunks or blocks over the
data-axis devices; the first device holds the corpus and the embedder:

1. WAV header probe and streaming ingest (host);
2. spectrogram (device) and energy segmentation (host);
3. embedding: the AE trained and encoded on the device (with
   ``autoencoder.overlap_clip_fraction``, trained on a worker thread while
   the rest of the corpus goes through its spectrograms), or PCA
   (covariance and projection on the device, eigensolve on the host);
   either restored from ``autoencoder.checkpoint``; with
   ``autoencoder.context_frames`` the embedder reads (2k+1)-frame slices
   stacked on the device (``ops/context.py``);
4. all-pairs DTW through the tiled scheduler and its kernel: K1 for a diag
   band, K4 or K5 for a widen band, K2 (segments up to 256 frames) or K3 (up
   to 4096) unbanded; unbanded and widen past 4096 frames through the
   per-pair scheduler, whose long buckets take K8, the blocked
   wavefront; with ``parallel.checkpoint_blocks`` each block persists under
   ``out_dir`` and a rerun reads it back;
5. clustering (host C++ NN-chain);
6. medoids and exemplar<->member alignments (plain-torch DTW with
   directions on the device, checkpointed for segments of 512 frames or
   more, backtrace on the host);
7. artifacts.

``discover(update_from=prior_out_dir)`` grows an index: the embedder is
frozen from the prior run's checkpoint, the prior segment table and a spot
check of stored distances guard the reuse, and the scheduler's ``known=``
computes only the pairs that touch a new clip.  ``query.py`` ranks new clips
against an index the same way.

``dtw.dtype=bfloat16`` runs the DTW per pair with the reference's bf16
Gram costs (``parallel/pair_scheduler.all_pairs_distances``); the
alignments stay fp32, as the reference's.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from audio_pattern_discovery_tpu_torch.cluster.agglomerative import cluster_distance_matrix
from audio_pattern_discovery_tpu_torch.config import PipelineConfig
from audio_pattern_discovery_tpu_torch.io.corpus import Clip, StreamingCorpus, pad_and_stack
from audio_pattern_discovery_tpu_torch.io.wavio import write_wav
from audio_pattern_discovery_tpu_torch.models.autoencoder import (
    FeatureScaler,
    encode_frames,
    train_autoencoder,
)
from audio_pattern_discovery_tpu_torch.models.pca import encode_pca, fit_pca
from audio_pattern_discovery_tpu_torch.ops.backtrace import paths_from_dirs
from audio_pattern_discovery_tpu_torch.ops.backtrace_ckpt import dtw_paths_checkpointed
from audio_pattern_discovery_tpu_torch.ops.context import flat_context, stack_context_device
from audio_pattern_discovery_tpu_torch.ops.dtw import dtw_batch_with_dirs
from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
    _dtw_batch_stripe,
    dtw_batch_pallas,
    dtw_tile_lane_diag_pairs,
    dtw_tile_lane_full_pairs,
    dtw_tile_lane_pairs,
    dtw_tile_pairs,
    dtw_tile_stripe_pairs,
)
from audio_pattern_discovery_tpu_torch.ops.dtw_long import dtw_long_batch
from audio_pattern_discovery_tpu_torch.ops.segmentation import Segment, segment_corpus
from audio_pattern_discovery_tpu_torch.ops.spectrogram import (
    mulaw_encode_host,
    num_frames,
    spectrogram_corpus,
)
from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances
from audio_pattern_discovery_tpu_torch.utils import checkpoint as ckpt
from audio_pattern_discovery_tpu_torch.utils.device import resolve_devices
from audio_pattern_discovery_tpu_torch.utils.logging import StageCounters, get_logger

# The all-pairs DTW kernels whose launches discover() counts (K1-K8).
DTW_KERNELS = (
    dtw_tile_lane_diag_pairs, dtw_tile_pairs, dtw_tile_lane_full_pairs, dtw_tile_lane_pairs,
    dtw_tile_stripe_pairs, dtw_batch_pallas, _dtw_batch_stripe, dtw_long_batch,
)


class _PreparedSignals:
    """Lazy per-clip upload preparation over a StreamingCorpus.

    Element i is clip i's samples ready for the device: "int16" for
    all-PCM16 corpora (exact: read_wav is raw/32768 for PCM16, so
    round(s*32768) round-trips bit-identically; the device divides by the
    clip peak), "mulaw8" for 8-bit mu-law of the peak-normalized signal
    (half of int16 again), "f32" otherwise (peak-normalized here when
    normalizing).  Peaks record into ``.peaks`` as clips load."""

    def __init__(self, stream: StreamingCorpus, codec: str, normalize: bool):
        self._stream = stream
        self._codec = codec
        self._normalize = normalize
        self._cache: list[np.ndarray | None] = [None] * len(stream)
        self.peaks = np.ones(len(stream), np.float32)

    def __len__(self) -> int:
        return len(self._cache)

    def _get(self, i: int) -> np.ndarray:
        v = self._cache[i]
        if v is None:
            s = self._stream[i].samples
            peak = max(float(np.abs(s).max()) if len(s) else 0.0, 1e-9)
            self.peaks[i] = peak
            if self._codec == "int16":
                v = np.round(s * 32768.0).astype(np.int16)
            elif self._codec == "mulaw8":
                v = mulaw_encode_host(s / peak)
            elif self._normalize:
                v = (s / peak).astype(np.float32)
            else:
                v = s
            self._cache[i] = v
        return v

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(len(self._cache))
            return [self._get(i) for i in range(start, stop, step)]
        return self._get(idx)


@dataclass
class ClusterReport:
    cluster_id: int
    exemplar: int                      # segment index of the medoid
    members: list[int]                 # segment indices
    alignments: dict[int, list[tuple[int, int]]] = field(default_factory=dict)


@dataclass
class DiscoveryResult:
    config: PipelineConfig
    clips: list[Clip]
    segments: list[Segment]
    seg_features: np.ndarray           # [K, L, d] padded DTW features
    seg_spectrograms: np.ndarray       # [K, L, bins] raw (log) spectrogram cuts
    seg_lengths: np.ndarray            # [K]
    distance_matrix: np.ndarray        # [K, K]
    labels: np.ndarray                 # [K] flat cluster labels (0-based)
    clusters: list[ClusterReport]
    ae_losses: list[float]
    counters: StageCounters

    def manifest(self) -> dict:
        """The cluster+alignment manifest."""
        hop = self.config.spectrogram.hop_length
        win = self.config.spectrogram.win_length
        clusters = []
        for rep in self.clusters:
            members = []
            for m in rep.members:
                seg = self.segments[m]
                clip = self.clips[seg.clip]
                members.append(
                    {
                        "segment": m,
                        "file": clip.path,
                        "sample_rate": clip.sample_rate,
                        "start_frame": seg.start_frame,
                        "end_frame": seg.end_frame,
                        "start_sample": seg.start_frame * hop,
                        "end_sample": (seg.end_frame - 1) * hop + win,
                        "is_exemplar": m == rep.exemplar,
                    }
                )
            clusters.append(
                {
                    "cluster_id": rep.cluster_id,
                    "exemplar": rep.exemplar,
                    "members": members,
                    "alignments": {
                        str(m): path for m, path in rep.alignments.items()
                    },
                }
            )
        from audio_pattern_discovery_tpu_torch.cluster.metrics import cluster_quality

        quality = cluster_quality(self.distance_matrix, self.labels)
        for c in clusters:
            c["quality"] = quality["clusters"].get(
                int(self.labels[c["exemplar"]]), {}
            )
        return {
            "n_clips": len(self.clips),
            "n_segments": len(self.segments),
            "n_clusters": len(self.clusters),
            "silhouette_mean": quality["silhouette_mean"],
            "clusters": clusters,
            "ae_losses": [round(x, 6) for x in self.ae_losses],
            "counters": self.counters.to_dict(),
        }


def _flat_frames(
    seg_frames: np.ndarray,        # [K, L, bins]
    seg_lengths: np.ndarray,
    n_segments: int,
    ctx: int = 0,
) -> np.ndarray:
    """All real (unpadded) segment frames as one [N, dim] training pool:
    (2k+1)-frame context slices when ctx > 0 (``ops/context.py``)."""
    if ctx > 0:
        return flat_context(seg_frames, seg_lengths, ctx)
    return np.concatenate(
        [seg_frames[k, : seg_lengths[k]] for k in range(n_segments)]
    )


def _flat_frames_device(
    frames_dev: torch.Tensor,      # [K, L, dim] on its device
    seg_lengths: np.ndarray,
) -> torch.Tensor:
    """``_flat_frames`` on the device of the resident segment tensor: its
    real (unpadded) rows in segment order, then frame order, gathered with
    no host round trip.  Given ``stack_context_device``'s output, the rows
    are ``flat_context``'s."""
    K, L, dim = frames_dev.shape
    rows = np.flatnonzero(np.arange(L) < np.asarray(seg_lengths, np.int64)[:, None])
    return frames_dev.reshape(K * L, dim)[torch.from_numpy(rows).to(frames_dev.device)]


def extract_segment_features(
    spectrograms: np.ndarray,      # [B, F, bins]
    segments: list[Segment],
    max_len: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Cut per-segment frame sequences and pad to [K, L, bins]."""
    seqs = [
        spectrograms[s.clip, s.start_frame : min(s.end_frame, s.start_frame + max_len)]
        for s in segments
    ]
    return pad_and_stack(seqs, pad_to=max_len)


def extract_segment_features_device(
    specs_dev: torch.Tensor,       # [B, F, bins] on the device
    segments: list[Segment],
    max_len: int,
) -> tuple[torch.Tensor, np.ndarray]:
    """Device-side extract_segment_features: one batched gather + mask, so
    the spectrogram corpus never crosses to the host (only segments do)."""
    F = specs_dev.shape[1]
    dev = specs_dev.device
    clip_idx = np.array([s.clip for s in segments], np.int64)
    starts = np.array([s.start_frame for s in segments], np.int64)
    lengths = np.minimum(
        np.array([s.end_frame - s.start_frame for s in segments], np.int32),
        max_len,
    )
    frame_idx = np.minimum(starts[:, None] + np.arange(max_len)[None, :], F - 1)
    seg = specs_dev[
        torch.from_numpy(clip_idx).to(dev)[:, None], torch.from_numpy(frame_idx).to(dev)
    ]
    mask = torch.from_numpy(
        np.arange(max_len)[None, :] < lengths[:, None]
    ).to(dev)
    return torch.where(mask[:, :, None], seg, 0.0), lengths


def _medoid(D: np.ndarray, members: list[int]) -> int:
    sub = D[np.ix_(members, members)]
    return members[int(np.argmin(sub.sum(axis=1)))]


def _feature_fingerprint(cfg: PipelineConfig) -> str:
    """Hash of the config knobs that determine segment features and DTW
    distance VALUES (same rule as the reference, so state.json files are
    interchangeable): keys equal to their dataclass default are dropped,
    and pure scheduling knobs are excluded."""
    import dataclasses
    import hashlib

    def nondefault(section) -> dict:
        d = dataclasses.asdict(section)
        for f in dataclasses.fields(section):
            default = (
                f.default_factory()
                if f.default_factory is not dataclasses.MISSING
                else f.default
            )
            if f.name in d and d[f.name] == default:
                d.pop(f.name)
        return d

    sp = nondefault(cfg.spectrogram)
    for k in ("clip_batch", "chunk_frames", "max_resident_bytes", "resample"):
        sp.pop(k, None)
    dt = nondefault(cfg.dtw)
    for k in ("pair_batch", "length_bucketing", "lane_stack"):
        dt.pop(k, None)
    ae = nondefault(cfg.autoencoder)
    if cfg.autoencoder.enabled:
        for k in ("checkpoint", "checkpoint_dir"):
            ae.pop(k, None)
    else:
        ae = {"enabled": False}
    payload = repr((sp, nondefault(cfg.segmentation), ae, dt))
    return hashlib.sha1(payload.encode()).hexdigest()


def _check_band_mode(state: dict, cfg: PipelineConfig, what: str) -> None:
    """Index reuse under another band mode gets an error naming the fix:
    state.json records the band_mode its distances were computed under (None
    when band was None); indexes without the key fall through to the spot
    check."""
    if cfg.dtw.band is None or "band_mode" not in state:
        return
    stored = state["band_mode"]
    current = cfg.dtw.band_mode
    if stored is not None and stored != current:
        raise ValueError(
            f"{what}: the prior index was computed with "
            f"dtw.band_mode={stored!r} but this run uses "
            f"dtw.band_mode={current!r} — banded distances are not "
            f"comparable across modes.  Re-run with "
            f"-s dtw.band_mode={stored} to reuse the index, or run a "
            f"full discovery to rebuild it under the new mode."
        )


def _validate_prior_segments(update_state: dict, segments: list[Segment]) -> int:
    """The corpus prefix must reproduce the stored segment table exactly, at
    the same indices (prior clips lead the clip order, and segmentation is
    per clip and deterministic); a mismatch means a prior file's content
    changed.  Returns k_old."""
    n_old_clips = len(update_state["clip_paths"])
    old_table = [tuple(s) for s in update_state["segments"]]
    k_old = len(old_table)
    got = [(s.clip, s.start_frame, s.end_frame) for s in segments[:k_old]]
    if got != old_table or any(s.clip < n_old_clips for s in segments[k_old:]):
        raise ValueError(
            "the prior clips segment differently than the stored table — "
            "were their files modified?  Stored distances would not match; "
            "run a full discovery instead"
        )
    return k_old


def _load_update_state(update_from: Path) -> tuple[dict, np.ndarray]:
    """(state.json, distance_matrix.npy) of a prior run's out_dir."""
    state_path = update_from / "state.json"
    d_path = update_from / "distance_matrix.npy"
    if not state_path.exists() or not d_path.exists():
        raise FileNotFoundError(
            f"--update needs a prior run's state.json + distance_matrix.npy "
            f"under {update_from}; run a full discovery there first"
        )
    state = json.loads(state_path.read_text())
    D_old = np.load(d_path)
    if D_old.shape != (len(state["segments"]),) * 2:
        raise ValueError(
            f"{d_path}: shape {D_old.shape} does not match the "
            f"{len(state['segments'])} segments recorded in state.json"
        )
    return state, D_old


def _has_embedder_checkpoint(cfg: PipelineConfig, ckpt_dir: Path) -> bool:
    if cfg.autoencoder.method == "pca":
        return ckpt.has_pca_checkpoint(ckpt_dir)
    return ckpt.has_ae_checkpoint(ckpt_dir)


def _prepare_corpus(
    cfg: PipelineConfig,
    stream: StreamingCorpus,
    counters: StageCounters,
    log,
    device: torch.device,
    devices: list | None = None,
):
    """Codec selection -> spectrogram -> energy segmentation -> segment
    frames: the one derivation that ``discover()`` and ``query.py`` share,
    since index reuse rests on fresh features reproducing the stored ones.
    ``devices`` (first ``device``): the spectrogram's clip groups round-robin
    over them.  Returns (clips, frame_counts, segments, seg_frames,
    seg_frames_dev, seg_lengths); seg_frames_dev is the device copy."""
    if cfg.spectrogram.upload_codec == "mulaw8":
        codec = "mulaw8"
    elif stream.all_pcm16:
        codec = "int16"
    else:
        codec = "f32"
    normalize = cfg.spectrogram.normalize_signal
    sigs = _PreparedSignals(stream, codec=codec, normalize=normalize)
    # int16 divides by the peak on the device when normalizing; mu-law codes
    # are of the peak-normalized signal, so the peak multiplies them back
    # when not normalizing.
    scales = (sigs.peaks if (codec == "int16" and normalize) or (codec == "mulaw8" and not normalize)
              else None)
    rates = np.unique(stream.sample_rates)
    n_resampled = int(getattr(stream, "_resample_mask", np.zeros(0, bool)).sum())
    if n_resampled:
        orig = np.unique(stream.original_rates)
        log.info(
            f"resampling {n_resampled}/{len(stream)} clip(s) "
            f"{sorted(int(r) for r in orig if r != cfg.spectrogram.sample_rate)}"
            f" Hz -> {cfg.spectrogram.sample_rate} Hz (spectrogram.resample=auto)"
        )
    elif len(rates) > 1:
        log.warning(
            f"corpus mixes sample rates {rates.tolist()}: frame times and "
            "DTW distances are not comparable across rates — set "
            "spectrogram.resample=auto or resample to one rate (config "
            f"expects {cfg.spectrogram.sample_rate} Hz)"
        )
    elif int(rates[0]) != cfg.spectrogram.sample_rate:
        log.warning(
            f"corpus sample rate {int(rates[0])} != configured "
            f"spectrogram.sample_rate {cfg.spectrogram.sample_rate}; "
            "window/hop lengths are in samples, so frame durations will "
            "differ from the configured intent (spectrogram.resample=auto "
            "converts instead)"
        )
    log.info(
        f"probed headers of {len(stream)} clips"
        + {"int16": " (PCM16: int16 device upload)",
           "mulaw8": " (mu-law int8 device upload)"}.get(codec, "")
    )
    # The spectrogram corpus stays on the device when it fits the budget;
    # only the energy matrix crosses to the host for segmentation.
    f_max_est = max(
        num_frames(int(n), cfg.spectrogram.win_length, cfg.spectrogram.hop_length)
        for n in stream.sample_lengths
    )
    resident_bytes = 4 * len(stream) * f_max_est * cfg.spectrogram.feature_dim
    on_device = resident_bytes <= cfg.spectrogram.max_resident_bytes
    with counters.time_stage("spectrogram"):
        specs_any, frame_counts, energies = spectrogram_corpus(
            sigs,
            cfg.spectrogram,
            device=device,
            clip_batch=cfg.spectrogram.clip_batch,
            chunk_frames=cfg.spectrogram.chunk_frames,
            return_device=on_device,
            scales=scales,
            sig_lengths=stream.sample_lengths,
            devices=devices,
        )
    clips = stream.materialize()

    with counters.time_stage("segmentation"):
        segments = segment_corpus(energies, frame_counts, cfg.segmentation)
    if not segments:
        return clips, frame_counts, segments, None, None, np.zeros(0, np.int32)
    if on_device:
        seg_frames_dev, seg_lengths = extract_segment_features_device(
            specs_any, segments, cfg.dtw.max_seq_len
        )
        seg_frames = seg_frames_dev.cpu().numpy()
    else:
        seg_frames, seg_lengths = extract_segment_features(
            specs_any, segments, cfg.dtw.max_seq_len
        )
        seg_frames_dev = torch.from_numpy(seg_frames).to(device)
    return clips, frame_counts, segments, seg_frames, seg_frames_dev, seg_lengths


def discover(
    wav_dir: str | Path,
    config: PipelineConfig | None = None,
    out_dir: str | Path | None = None,
    logger=None,
    update_from: str | Path | None = None,
    device: torch.device | str | list = "cuda",
) -> DiscoveryResult:
    """Run the discovery pipeline over a directory of WAV files on
    ``device``: every card by default (``"cuda"``; ``"cuda:1"`` one card);
    without one this raises unless the caller passes ``device="cpu"``.  A
    list of devices (it may repeat one) is the reference's device list: the
    first ``n_data`` of them (all with ``parallel.data_axis`` < 0, else
    ``data_axis * model_axis``) form the mesh, and with ``n_data`` of 1
    the run is the one-device run.

    ``update_from``: a prior run's out_dir (state.json,
    distance_matrix.npy and, with the embedder on, its checkpoint).  Only
    DTW pairs touching clips added since that run are computed; the linear
    stages re-run over the whole corpus and the embedder is frozen from the
    prior run's checkpoint, which keeps the stored distances valid.  It
    requires the feature-affecting config unchanged, every prior WAV still
    present, and a saved checkpoint when the embedder is on."""
    cfg = (config or PipelineConfig()).validate()
    devices = resolve_devices(device)
    device = devices[0]
    log = logger or get_logger()
    counters = StageCounters()
    log.info(f"device {device}")
    ae = cfg.autoencoder

    # The mesh (the reference's): DTW chunks or blocks and spectrogram clip
    # groups round-robin over the data-axis devices, AE minibatches split
    # over the data axis (and its layers over the model axis).  One device
    # runs unchanged.
    par = cfg.parallel
    n_data = (len(devices) if par.data_axis < 0
              else min(par.data_axis * max(par.model_axis, 1), len(devices)))
    data_devices = devices[:n_data] if n_data > 1 else None
    ae_mesh: dict = {}
    if n_data > 1:
        from audio_pattern_discovery_tpu_torch.parallel.mesh import (
            ae_param_sharding,
            data_sharding,
            make_mesh,
        )

        mesh = make_mesh(par, devices=devices)
        ae_mesh["data_sharding"] = data_sharding(mesh)
        if par.model_axis > 1:
            ae_mesh["param_shardings"] = lambda p: ae_param_sharding(mesh, p)
            log.info(f"mesh {mesh.shape}: DP over data axis, AE TP over model axis "
                     f"({[str(d) for d in mesh.device_list]})")
        else:
            log.info(f"data-parallel over {n_data} devices ({[str(d) for d in data_devices]})")

    update_state: dict | None = None
    D_old: np.ndarray | None = None
    k_old = 0
    if update_from is not None:
        update_from = Path(update_from)
        update_state, D_old = _load_update_state(update_from)
        _check_band_mode(update_state, cfg, "update_from")
        if update_state["feature_fingerprint"] != _feature_fingerprint(cfg):
            raise ValueError(
                "update_from: a feature-affecting config section "
                "(spectrogram/segmentation/autoencoder/dtw) differs from the "
                "prior run's — the stored distances would not match; run a "
                "full discovery instead"
            )
        if ae.enabled and not _has_embedder_checkpoint(cfg, update_from / ae.checkpoint_dir):
            raise ValueError(
                "update_from: the embedding is enabled but the prior "
                "run saved no checkpoint — the frozen embedding model is "
                "required to reuse its distances (rerun the full "
                "discovery with -s autoencoder.checkpoint=true)"
            )

    # ---- ingest (headers now, samples as the spectrogram stage needs them)
    with counters.time_stage("ingest"):
        ordered_paths = None
        if update_state is not None:
            # Prior clips keep their indices (stored order); new files
            # append after them, sorted.
            stored = [Path(p) for p in update_state["clip_paths"]]
            listing = sorted(Path(wav_dir).glob("*.wav"))
            listing_resolved = {p.resolve() for p in listing}
            missing = [str(p) for p in stored if p.resolve() not in listing_resolved]
            if missing:
                raise ValueError(
                    f"update_from: {len(missing)} clip(s) from the prior run "
                    f"are no longer under {wav_dir} (e.g. {missing[0]}); "
                    "removing clips invalidates the stored distances — run a "
                    "full discovery instead"
                )
            old_resolved = {p.resolve() for p in stored}
            new_paths = [p for p in listing if p.resolve() not in old_resolved]
            ordered_paths = stored + new_paths
            log.info(f"update: {len(stored)} prior clips, {len(new_paths)} new")
        stream = StreamingCorpus(
            wav_dir,
            paths=ordered_paths,
            resample_to=(
                cfg.spectrogram.sample_rate
                if cfg.spectrogram.resample == "auto"
                else None
            ),
        )
    counters.add("clips", len(stream))

    # ---- spectrograms -> segmentation -> segment frames.  With
    # autoencoder.overlap_clip_fraction the corpus runs through the same
    # derivation in two contiguous phases, and the AE trains on phase 1's
    # segment frames on a worker thread while phase 2's spectrograms run.
    # Segmentation is per clip, so the segment table is the single-phase
    # one; only the AE's training pool (and so the embedding) differs.  An
    # update restores the prior embedder, so it never trains.
    ctx = ae.context_frames if ae.enabled else 0
    ckpt_dir = None
    if ae.enabled and ae.checkpoint and out_dir is not None:
        ckpt_dir = Path(out_dir) / ae.checkpoint_dir
    # An update restores the PRIOR run's checkpoint whatever this run's
    # checkpoint flag: the frozen embedder keeps the reused distances valid.
    restore_dir = update_from / ae.checkpoint_dir if update_state is not None else ckpt_dir
    frac = ae.overlap_clip_fraction
    two_phase = (
        0.0 < frac < 1.0
        and ae.enabled
        and ae.method == "ae"
        and update_state is None
        and len(stream) >= 2
        # A restorable checkpoint means training never runs.
        and not (ckpt_dir is not None and ckpt.has_ae_checkpoint(ckpt_dir))
    )
    pre_train = None          # (future of train_autoencoder's result, scaler)
    if two_phase:
        m = max(1, min(len(stream) - 1, int(np.ceil(frac * len(stream)))))
        c1, fc1, segs1, sf1, sfd1, sl1 = _prepare_corpus(
            cfg, stream.view(0, m), counters, log, device, data_devices
        )
        if len(segs1) >= 2:
            flat1 = _flat_frames(sf1, sl1, len(segs1), ctx)
            scaler1 = FeatureScaler.fit(flat1)
            pre_train = (
                _train_in_background(scaler1.transform(flat1).astype(np.float32), ae, device,
                                     ae_mesh, counters),
                scaler1,
            )
            counters.add("ae_train_frames", len(flat1))
            log.info(
                f"overlap: AE training launched on {len(segs1)} segments "
                f"from the first {m}/{len(stream)} clips; remaining "
                "spectrograms proceed beside it"
            )
        else:
            log.warning(
                f"overlap: only {len(segs1)} segment(s) in the first "
                f"{m} clips — training deferred to the full corpus"
            )
        c2, fc2, segs2, sf2, sfd2, sl2 = _prepare_corpus(
            cfg, stream.view(m, len(stream)), counters, log, device, data_devices
        )
        clips = c1 + c2
        frame_counts = np.concatenate([fc1, fc2])
        segments = segs1 + [Segment(s.clip + m, s.start_frame, s.end_frame) for s in segs2]
        # Both phases pad to cfg.dtw.max_seq_len, so their segment tensors
        # concatenate directly; a phase without segments has none.
        halves = [h for h in ((sf1, sfd1, sl1), (sf2, sfd2, sl2)) if h[0] is not None]
        seg_frames = np.concatenate([h[0] for h in halves]) if halves else None
        seg_frames_dev = torch.cat([h[1] for h in halves]) if halves else None
        seg_lengths = (np.concatenate([h[2] for h in halves]) if halves
                       else np.zeros(0, np.int32))
        del sf1, sf2, sfd1, sfd2, halves
    else:
        clips, frame_counts, segments, seg_frames, seg_frames_dev, seg_lengths = (
            _prepare_corpus(cfg, stream, counters, log, device, data_devices)
        )
    counters.add("frames", float(frame_counts.sum()))
    counters.add("segments", len(segments))
    log.info(f"segmented into {len(segments)} candidates")
    if len(segments) < 2:
        raise ValueError(
            f"only {len(segments)} segments found; loosen segmentation config"
        )
    if update_state is not None:
        try:
            k_old = _validate_prior_segments(update_state, segments)
        except ValueError as e:
            raise ValueError(f"update_from: {e}") from None

    # ---- embedding (device): PCA, or the AE trained (or restored) + encode.
    # Temporal context: the embedder reads (2k+1)-frame slices stacked on
    # the device from the resident segment tensor; seg_frames stays raw (it
    # feeds images and snippets too).
    emb_frames_dev = seg_frames_dev
    if ctx > 0:
        with counters.time_stage("context_stack"):
            emb_frames_dev = stack_context_device(seg_frames_dev, seg_lengths, ctx)
    ae_losses: list[float] = []
    if ae.enabled and ae.method == "pca":
        # The scaler, the standardization and the covariance on the device
        # from the resident frames; the eigensolve on the host (models/pca.py).
        with counters.time_stage("embedding_fit"):
            if restore_dir is not None and ckpt.has_pca_checkpoint(restore_dir):
                pca_state, scaler = ckpt.restore_pca_checkpoint(restore_dir)
                counters.add("embedding_fit_device", 0)
                log.info(f"restored PCA embedding from {restore_dir}")
                if ckpt_dir is not None and ckpt_dir.resolve() != restore_dir.resolve():
                    ckpt.save_pca_checkpoint(ckpt_dir, pca_state, scaler)
            else:
                flat_dev = _flat_frames_device(emb_frames_dev, seg_lengths)
                scaler = FeatureScaler.fit(flat_dev)
                pca_state = fit_pca(
                    scaler.transform_(flat_dev),
                    ae.latent_dim,
                    whiten=ae.pca_whiten,
                    device=device,
                )
                del flat_dev
                counters.add("embedding_fit_device", 1)
                log.info(
                    f"PCA embedding: {ae.latent_dim} components "
                    f"capture {100 * float(pca_state.explained.sum()):.1f}% "
                    "of frame variance"
                )
                if ckpt_dir is not None:
                    ckpt.save_pca_checkpoint(ckpt_dir, pca_state, scaler)
        with counters.time_stage("embedding_encode"):
            features_dev = encode_pca(pca_state, scaler.transform(emb_frames_dev))
            features = features_dev.cpu().numpy()
    elif ae.enabled:
        with counters.time_stage("autoencoder_train"):
            # Trains on the real (unpadded) frames of all segments, unless a
            # checkpoint restores the model (and its scaler).
            if restore_dir is not None and ckpt.has_ae_checkpoint(restore_dir):
                model, state, scaler = ckpt.restore_ae_checkpoint(
                    restore_dir, ae, seg_frames.shape[-1] * (2 * ctx + 1), device=device
                )
                if scaler is None:
                    if update_state is not None:
                        raise ValueError(
                            "update_from: the prior checkpoint has no saved "
                            "feature scaler; refitting on the grown corpus "
                            "would shift every embedding — run a full "
                            "discovery instead"
                        )
                    flat = _flat_frames(seg_frames, seg_lengths, len(segments), ctx)
                    with counters.time_stage("autoencoder_train.scaler_fit"):
                        scaler = FeatureScaler.fit(flat)
                log.info(f"restored AE checkpoint from {restore_dir}")
                if ckpt_dir is not None and ckpt_dir.resolve() != restore_dir.resolve():
                    ckpt.save_ae_checkpoint(ckpt_dir, state, scaler)
            else:
                if pre_train is not None:
                    # Launched mid-corpus: this stage times only the drain;
                    # epochs already done beside phase 2 cost nothing here
                    # (their enqueue is "autoencoder_train.steps_enqueued").
                    future, scaler = pre_train
                    model, state, loss_futs = future.result()
                    ae_losses = torch.stack(loss_futs).tolist() if loss_futs else []
                else:
                    flat = _flat_frames(seg_frames, seg_lengths, len(segments), ctx)
                    with counters.time_stage("autoencoder_train.scaler_fit"):
                        scaler = FeatureScaler.fit(flat)
                    counters.add("ae_train_frames", len(flat))
                    model, state, ae_losses = train_autoencoder(
                        scaler.transform(flat).astype(np.float32), ae, logger=log,
                        device=device, counters=counters, **ae_mesh,
                    )
                if ckpt_dir is not None:
                    ckpt.save_ae_checkpoint(ckpt_dir, state, scaler)
        with counters.time_stage("autoencoder_encode"):
            # Standardized on the device from the resident segment tensor.
            features_dev = encode_frames(model, state.params, scaler.transform(emb_frames_dev))
            features = features_dev.cpu().numpy()
    else:
        features_dev, features = seg_frames_dev, seg_frames
    seg_frames_dev = emb_frames_dev = None
    counters.add("feature_dim", features.shape[-1])

    if update_state is not None:
        # Drift guard before committing to reuse: a few stored pairs
        # recomputed from the fresh features against D_old.
        from audio_pattern_discovery_tpu_torch.query import spot_check_prior_distances

        spot_check_prior_distances(features_dev, seg_lengths, cfg.dtw, D_old, k_old)

    # ---- all-pairs DTW (device, the hot loop)
    block_dir = None
    if cfg.parallel.checkpoint_blocks and out_dir is not None:
        block_dir = Path(out_dir) / cfg.parallel.block_dir
    launches0 = [k.launches for k in DTW_KERNELS]
    dtw_stats: dict = {}
    with counters.time_stage("dtw"):
        D = all_pairs_distances(
            features_dev, seg_lengths, cfg.dtw, device=device, block_dir=block_dir,
            known=None if update_state is None else (k_old, D_old), stats=dtw_stats,
            devices=data_devices,
        )
    features_dev = None
    launched = [k.launches - n0 for k, n0 in zip(DTW_KERNELS, launches0)]
    counters.add("dtw_kernel_launches", sum(launched))
    # The work the kernels were given: tile-pairs (ti x ti pairs each; none
    # on the per-pair route), and the blocks read back from block_dir
    # instead.
    counters.add("dtw_tile_programs", dtw_stats.get("tile_programs", 0))
    counters.add("dtw_blocks_resumed", dtw_stats["blocks_resumed"])
    for k, n in zip(DTW_KERNELS, launched):
        counters.add(f"launches.{k.__name__}", n)
    n_pairs = len(segments) * (len(segments) - 1) // 2
    if update_state is not None:
        reused = k_old * (k_old - 1) // 2
        n_pairs -= reused
        counters.add("dtw_pairs_reused", reused)
    counters.add("dtw_pairs", n_pairs)
    dtw_s = counters.timings_s.get("dtw", 0.0)
    if dtw_s > 0:
        counters.add("dtw_pairs_per_sec", n_pairs / dtw_s)

    # ---- clustering (host)
    with counters.time_stage("clustering"):
        ccfg = cfg.cluster
        thr = ccfg.distance_threshold
        if thr is None and ccfg.n_clusters is None:
            from audio_pattern_discovery_tpu_torch.cluster.agglomerative import (
                auto_cut_threshold,
                cut_linkage,
                linkage,
            )

            Z = linkage(D, ccfg.linkage, use_native=ccfg.use_native)
            thr = auto_cut_threshold(
                Z,
                quantile=ccfg.auto_cut_quantile,
                min_rel_gap=(
                    ccfg.auto_cut_min_rel_gap if ccfg.auto_cut == "gap" else np.inf
                ),
            )
            labels = cut_linkage(Z, D.shape[0], distance_threshold=thr)
        else:
            labels, _ = cluster_distance_matrix(
                D,
                ccfg.linkage,
                distance_threshold=thr,
                n_clusters=ccfg.n_clusters,
                use_native=ccfg.use_native,
            )
    counters.add("clusters_raw", len(np.unique(labels)))

    # ---- motif extraction + alignments
    ckpt0 = dtw_paths_checkpointed.calls
    with counters.time_stage("extraction"):
        clusters = _extract_clusters(D, labels, features, seg_lengths, cfg, device)
    counters.add("clusters", len(clusters))
    counters.add("alignments_checkpointed", dtw_paths_checkpointed.calls - ckpt0)
    log.info(f"discovered {len(clusters)} pattern clusters")

    result = DiscoveryResult(
        config=cfg,
        clips=clips,
        segments=segments,
        seg_features=features,
        seg_spectrograms=seg_frames,
        seg_lengths=seg_lengths,
        distance_matrix=D,
        labels=labels,
        clusters=clusters,
        ae_losses=ae_losses,
        counters=counters,
    )
    if out_dir is not None:
        # The manifest is written inside this stage, so it cannot hold its
        # seconds; the CLI's summary and the worker's reply do.
        with counters.time_stage("write_artifacts"):
            write_artifacts(result, out_dir, log)
    return result


def _train_in_background(frames: np.ndarray, cfg, device: torch.device, ae_mesh: dict,
                         counters: StageCounters):
    """Start ``train_autoencoder(frames, cfg, sync_losses=False, **ae_mesh)``
    on a worker thread, recording into ``counters``, and return its future.  On the card the thread queues its
    work on a stream of its own and waits for that stream before it
    returns, so once the future is done its tensors are ready on every
    stream."""
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def run():
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            out = train_autoencoder(frames, cfg, sync_losses=False, device=device,
                                    counters=counters, **ae_mesh)
        if stream is not None:
            stream.synchronize()
        return out

    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="apd-ae-train")
    future = pool.submit(run)
    pool.shutdown(wait=False)
    return future


def _extract_clusters(
    D: np.ndarray,
    labels: np.ndarray,
    features: np.ndarray,
    seg_lengths: np.ndarray,
    cfg: PipelineConfig,
    device: torch.device,
) -> list[ClusterReport]:
    """Medoid exemplars + exemplar<->member alignments per cluster."""
    reports: list[ClusterReport] = []
    order = []
    for lab in np.unique(labels):
        members = np.flatnonzero(labels == lab).tolist()
        if len(members) < cfg.cluster.min_cluster_size:
            continue
        order.append((len(members), -int(lab), members))
    # Stable output ids: biggest clusters first.
    order.sort(reverse=True)

    for new_id, (_, _, members) in enumerate(order):
        exemplar = _medoid(D, members)
        rep = ClusterReport(cluster_id=new_id, exemplar=exemplar, members=members)
        if cfg.output.write_alignments and len(members) > 1:
            others = [m for m in members if m != exemplar]
            rep.alignments = _cluster_alignments(
                exemplar, others, features, seg_lengths, cfg, device
            )
        reports.append(rep)
    return reports


# The with-dirs DTW materializes ~16 bytes per DP cell; chunking keeps every
# call under this budget.
_ALIGN_BYTES_BUDGET = 512 * 1024 * 1024


def _cluster_alignments(
    exemplar: int,
    others: list[int],
    features: np.ndarray,
    seg_lengths: np.ndarray,
    cfg: PipelineConfig,
    device: torch.device,
) -> dict[int, list[tuple[int, int]]]:
    """Exemplar<->member warping paths in bounded device memory: sequences
    trimmed to the cluster's next-pow2 length, members chunked under
    _ALIGN_BYTES_BUDGET (chunks padded to one power-of-two size with
    exemplar self-alignments, discarded).  Long sequences (L >= 512) take
    the checkpointed backtrace (ops/backtrace_ckpt.py), which gives the same
    paths without a [B, N+M-1, M] direction tensor."""
    idx_all = np.asarray(others)
    la_all = seg_lengths[np.full(len(others), exemplar)]
    lb_all = seg_lengths[idx_all]
    lmax = int(max(int(la_all.max()), int(lb_all.max()), 8))
    L = min(features.shape[1], 1 << (lmax - 1).bit_length())

    if L >= 512:
        paths = dtw_paths_checkpointed(
            torch.from_numpy(features[np.full(len(others), exemplar), :L]).to(device),
            torch.from_numpy(features[idx_all, :L]).to(device),
            la_all,
            lb_all,
            metric=cfg.dtw.metric,
            band=cfg.dtw.band,
            auto_widen=cfg.dtw.auto_widen_band,
            band_mode=cfg.dtw.band_mode,
        )
        return {m: p for m, p in zip(others, paths)}

    bytes_per_pair = 16 * (2 * L) * L
    chunk = max(1, _ALIGN_BYTES_BUDGET // bytes_per_pair)
    n = len(others)
    n_chunk = 1 << (min(chunk, n).bit_length() - 1)

    paths: list[list[tuple[int, int]]] = []
    for s in range(0, n, n_chunk):
        sel = idx_all[s : s + n_chunk]
        m = len(sel)
        pad_idx = np.concatenate([sel, np.full(n_chunk - m, exemplar)])
        la = seg_lengths[np.full(n_chunk, exemplar)]
        lb = seg_lengths[pad_idx]
        _, dirs = dtw_batch_with_dirs(
            torch.from_numpy(features[np.full(n_chunk, exemplar), :L]).to(device),
            torch.from_numpy(features[pad_idx, :L]).to(device),
            torch.from_numpy(la).to(device),
            torch.from_numpy(lb).to(device),
            metric=cfg.dtw.metric,
            band=cfg.dtw.band,
            auto_widen=cfg.dtw.auto_widen_band,
            band_mode=cfg.dtw.band_mode,
        )
        paths.extend(paths_from_dirs(dirs.cpu().numpy()[:m], la[:m], lb[:m]))
    return {m: p for m, p in zip(others, paths)}


def write_artifacts(result: DiscoveryResult, out_dir: str | Path, log=None) -> None:
    """Cluster manifest, distance matrix, state, label tracks, images, HTML
    report and per-cluster audio snippets."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = result.config
    manifest = result.manifest()
    (out / cfg.output.manifest_name).write_text(json.dumps(manifest, indent=2))
    np.save(out / "distance_matrix.npy", result.distance_matrix)
    state = {
        "version": 1,
        "clip_paths": [str(Path(c.path).resolve()) for c in result.clips],
        "sample_rates": [c.sample_rate for c in result.clips],
        "segments": [
            [s.clip, s.start_frame, s.end_frame] for s in result.segments
        ],
        "feature_fingerprint": _feature_fingerprint(cfg),
        "band_mode": cfg.dtw.band_mode if cfg.dtw.band is not None else None,
    }
    (out / "state.json").write_text(json.dumps(state))
    if cfg.output.write_features:
        np.savez_compressed(
            out / "features.npz",
            features=result.seg_features,
            lengths=result.seg_lengths,
            labels=result.labels,
        )
    if cfg.output.write_label_tracks and result.clusters:
        lab_dir = out / "labels"
        lab_dir.mkdir(exist_ok=True)
        hop = cfg.spectrogram.hop_length
        win = cfg.spectrogram.win_length
        per_clip: dict[int, list[tuple[float, float, str]]] = {}
        for rep in result.clusters:
            for m in rep.members:
                seg = result.segments[m]
                sr = result.clips[seg.clip].sample_rate
                per_clip.setdefault(seg.clip, []).append(
                    (
                        seg.start_frame * hop / sr,
                        ((seg.end_frame - 1) * hop + win) / sr,
                        f"cluster{rep.cluster_id:03d}",
                    )
                )
        for ci, rows in per_clip.items():
            stem = Path(result.clips[ci].path).stem
            (lab_dir / f"{stem}.txt").write_text(
                "".join(
                    f"{s:.6f}\t{e:.6f}\t{lab}\n" for s, e, lab in sorted(rows)
                )
            )
    if cfg.output.write_images and result.clusters:
        if importlib.util.find_spec("matplotlib") is None:
            (log or get_logger()).warning(
                "matplotlib is not installed: skipping the per-cluster "
                "spectrogram images (output.write_images)"
            )
        else:
            from audio_pattern_discovery_tpu_torch.io.images import write_cluster_images

            write_cluster_images(
                out / "images",
                result.clusters,
                result.seg_spectrograms,
                result.seg_lengths,
                max_per_cluster=cfg.output.max_images_per_cluster,
            )
    if cfg.output.write_html_report:
        from audio_pattern_discovery_tpu_torch.io.report import write_html_report

        write_html_report(out, manifest)
    if cfg.output.write_snippets:
        hop = cfg.spectrogram.hop_length
        win = cfg.spectrogram.win_length
        snip_dir = out / "snippets"
        snip_dir.mkdir(exist_ok=True)
        for rep in result.clusters:
            for m in rep.members:
                seg = result.segments[m]
                clip = result.clips[seg.clip]
                s0 = seg.start_frame * hop
                s1 = min((seg.end_frame - 1) * hop + win, len(clip.samples))
                write_wav(
                    snip_dir / f"cluster{rep.cluster_id:03d}_seg{m:05d}.wav",
                    clip.samples[s0:s1],
                    clip.sample_rate,
                )
