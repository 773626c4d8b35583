"""Plain NumPy front end: WAVs to energy segments and their log spectra.

The semantics of the port's ``oracle/stft.py`` and ``ops/segmentation.py``,
in float64: each clip peak-normalized, frames cut without padding (frame t
covers samples [t*hop, t*hop + win)), a periodic Hann window, |rfft|^2 and
log10 of it above ``log_floor``; a frame's energy is log10 of its mean
power; segments are the runs of frames within ``threshold_db`` of the clip's
peak energy (and above ``min_energy_db``), gaps of up to ``merge_gap_frames``
merged, runs shorter than ``min_len_frames`` dropped and longer ones split
at ``max_len_frames``.  ``precision="bf16"`` or ``"tf32"`` (the controls)
rounds each windowed frame to bfloat16 or TF32 before its transform.
Imports nothing of the program.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.corpus import read_wav_pcm16
from benchmark.reference.precision import rounded


def _rounded(x: np.ndarray, precision: str) -> np.ndarray:
    return rounded(torch.from_numpy(x.astype(np.float32)), precision).double().numpy()


def log_spectrogram(x: np.ndarray, win: int, hop: int, log_floor: float,
                    block: int = 4096, precision: str = "fp64") -> np.ndarray:
    """[frames, win//2 + 1] float64 log10 power spectrogram."""
    nf = 0 if len(x) < win else 1 + (len(x) - win) // hop
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)
    out = np.empty((nf, win // 2 + 1))
    for s in range(0, nf, block):
        idx = np.arange(s, min(nf, s + block))[:, None] * hop + np.arange(win)[None, :]
        frames = x[idx] * w
        if precision != "fp64":
            frames = _rounded(frames, precision)
        spec = np.fft.rfft(frames, n=win, axis=1)
        out[s:s + len(idx)] = np.log10(np.maximum(spec.real ** 2 + spec.imag ** 2, log_floor))
    return out


def _runs(mask: np.ndarray, gap: int) -> list[tuple[int, int]]:
    padded = np.concatenate([[False], mask, [False]]).astype(np.int8)
    d = np.diff(padded)
    runs = list(zip(np.flatnonzero(d == 1).tolist(), np.flatnonzero(d == -1).tolist()))
    merged: list[tuple[int, int]] = []
    for s, e in runs:
        if merged and s - merged[-1][1] <= gap:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def frames_gap(got: np.ndarray, want: np.ndarray, lengths: np.ndarray) -> float:
    """The largest gap of a bin's power between two log10 spectra of the
    same segments, over its frame's total power (the reference's)."""
    worst = 0.0
    for k, n in enumerate(lengths):
        p, r = 10.0 ** np.asarray(got[k, :n], np.float64), 10.0 ** want[k, :n]
        worst = max(worst, float(np.max(np.abs(p - r).max(1) / r.sum(1))) if n else 0.0)
    return worst


def segment_runs(energy: np.ndarray, seg: dict) -> list[tuple[int, int]]:
    """(start, end) frames of one clip's energy-gated segments."""
    if len(energy) == 0:
        return []
    thr = max(energy.max() + seg["threshold_db"] / 10.0, seg["min_energy_db"] / 10.0)
    out = []
    for s, e in _runs(energy >= thr, seg["merge_gap_frames"]):
        if e - s < seg["min_len_frames"]:
            continue
        while e - s > seg["max_len_frames"]:
            out.append((s, s + seg["max_len_frames"]))
            s += seg["max_len_frames"]
        if e - s >= seg["min_len_frames"]:
            out.append((s, e))
    return out


def front_end(wavs: list[Path], spec: dict, seg: dict, max_len: int, precision: str = "fp64"):
    """(segments [(clip, start, end)], frames [K, max_len, bins] float64 zero
    past each length, lengths [K]) of the clips in ``wavs``, in order."""
    segments, cuts = [], []
    for ci, path in enumerate(wavs):
        raw, rate = read_wav_pcm16(path)
        if rate != spec["sample_rate"]:
            raise ValueError(f"{path}: {rate} Hz, the configuration reads {spec['sample_rate']}")
        x = raw.astype(np.float64) / 32768.0
        if spec["normalize_signal"]:
            x = x / max(float(np.abs(x).max()) if len(x) else 0.0, 1e-9)
        logs = log_spectrogram(x, spec["win_length"], spec["hop_length"], spec["log_floor"],
                               precision=precision)
        energy = np.log10(np.maximum(np.mean(10.0 ** logs, axis=1), 1e-10))
        for s, e in segment_runs(energy, seg):
            segments.append((ci, s, e))
            cuts.append(logs[s:min(e, s + max_len)])
    bins = spec["win_length"] // 2 + 1
    frames = np.zeros((len(cuts), max_len, bins))
    lengths = np.array([len(c) for c in cuts], np.int64)
    for k, c in enumerate(cuts):
        frames[k, :len(c)] = c
    return segments, frames, lengths
