"""Segmentation of spectrograms into candidate pattern segments (SS3 row 3).

Frame energies are computed on-device (ops/spectrogram.frame_energy); the
run-length logic (gating, gap merging, min/max length) is inherently
sequential per clip and latency-trivial, so it runs vectorized on the host —
the same host/device split the reference's pipeline implies (SURVEY.md SS4.1:
everything around the hot kernels stays on host).

Copy of ``audio_pattern_discovery_tpu/ops/segmentation.py``; only the import paths differ.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from audio_pattern_discovery_tpu_torch.config import SegmentationConfig


@dataclass
class Segment:
    clip: int            # clip index within the corpus
    start_frame: int
    end_frame: int       # exclusive

    @property
    def n_frames(self) -> int:
        return self.end_frame - self.start_frame


def _runs_from_mask(mask: np.ndarray) -> list[tuple[int, int]]:
    """Boolean [F] -> list of (start, end) runs of True."""
    if not mask.any():
        return []
    padded = np.concatenate([[False], mask, [False]])
    diff = np.diff(padded.astype(np.int8))
    starts = np.nonzero(diff == 1)[0]
    ends = np.nonzero(diff == -1)[0]
    return list(zip(starts.tolist(), ends.tolist()))


def _merge_gaps(runs: list[tuple[int, int]], gap: int) -> list[tuple[int, int]]:
    if not runs:
        return runs
    merged = [runs[0]]
    for s, e in runs[1:]:
        ps, pe = merged[-1]
        if s - pe <= gap:
            merged[-1] = (ps, e)
        else:
            merged.append((s, e))
    return merged


def segment_energy(
    energies: np.ndarray,      # [F] per-frame energy (log10-power mean)
    n_frames: int,
    cfg: SegmentationConfig,
) -> list[tuple[int, int]]:
    """Energy-gated runs for one clip.  Threshold is relative to clip peak:
    active frames satisfy energy >= peak + threshold_db/10 (log10-power units,
    10*log10 = dB, so threshold_db dB below peak)."""
    e = np.asarray(energies[:n_frames], dtype=np.float64)
    if len(e) == 0:
        return []
    # Absolute floor: a silent/uniform clip (all frames at the noise floor)
    # must yield NO segments, not one giant run — the peak-relative gate
    # alone would activate every frame when peak == floor.
    thr = max(e.max() + cfg.threshold_db / 10.0, cfg.min_energy_db / 10.0)
    runs = _merge_gaps(_runs_from_mask(e >= thr), cfg.merge_gap_frames)
    out: list[tuple[int, int]] = []
    for s, end in runs:
        if end - s < cfg.min_len_frames:
            continue
        # Split over-long runs into max_len chunks (tail keeps min_len rule).
        while end - s > cfg.max_len_frames:
            out.append((s, s + cfg.max_len_frames))
            s += cfg.max_len_frames
        if end - s >= cfg.min_len_frames:
            out.append((s, end))
    return out


def segment_sliding(n_frames: int, cfg: SegmentationConfig) -> list[tuple[int, int]]:
    """Fixed sliding windows (the 'spectrogram windows' mode, BASELINE config 3)."""
    out = []
    s = 0
    while s + cfg.window_frames <= n_frames:
        out.append((s, s + cfg.window_frames))
        s += cfg.stride_frames
    if not out and n_frames >= cfg.min_len_frames:
        out.append((0, n_frames))
    return out


def segment_corpus(
    energies: np.ndarray,       # [B, F]
    frame_counts: np.ndarray,   # [B]
    cfg: SegmentationConfig,
) -> list[Segment]:
    """All candidate segments across a corpus batch, deterministic order."""
    segments: list[Segment] = []
    for ci in range(energies.shape[0]):
        nf = int(frame_counts[ci])
        if cfg.method == "energy":
            runs = segment_energy(energies[ci], nf, cfg)
        elif cfg.method == "sliding":
            runs = segment_sliding(nf, cfg)
        else:
            raise ValueError(f"unknown segmentation method {cfg.method!r}")
        segments.extend(Segment(ci, s, e) for s, e in runs)
    return segments
