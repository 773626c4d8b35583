"""Synthetic corpus generator with planted motifs (SURVEY.md SS5.2).

Generates WAV clips containing known repeated motifs (chirps / tone stacks /
warbles) embedded in noise, plus the ground-truth occurrence table.  The
end-to-end integration test asserts discovery recovers the planted clusters —
the behavioral contract proxy for the reference corpus (mount empty, SS0).

Copy of ``audio_pattern_discovery_tpu/synthetic.py``; only the import paths differ.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from audio_pattern_discovery_tpu_torch.io.wavio import write_wav


@dataclass
class Occurrence:
    clip: int          # clip index
    motif: int         # motif id (ground-truth cluster)
    start: int         # sample offset
    length: int        # samples


def _motif_bank(n_motifs: int, sr: int, rng: np.random.Generator):
    """Distinct parametric motif synthesizers; each returns samples."""

    def chirp(f0, f1, dur):
        t = np.arange(int(dur * sr)) / sr
        phase = 2 * np.pi * (f0 * t + 0.5 * (f1 - f0) / dur * t * t)
        return np.sin(phase)

    def warble(fc, fm, depth, dur):
        t = np.arange(int(dur * sr)) / sr
        inst = fc + depth * np.sin(2 * np.pi * fm * t)
        return np.sin(2 * np.pi * np.cumsum(inst) / sr)

    def stack(freqs, dur):
        t = np.arange(int(dur * sr)) / sr
        return sum(np.sin(2 * np.pi * f * t) for f in freqs) / len(freqs)

    # Highest multiplier below is 2.7 (tone stack) / ~2.6 (chirp top), so cap
    # the base such that every partial stays under 0.45*sr (below Nyquist
    # with margin) — otherwise many-motif banks at 16 kHz would alias and
    # corrupt the planted ground truth.
    base_cap = 0.45 * sr / 2.7

    protos = []
    for k in range(n_motifs):
        kind = k % 3
        base = 400.0 + 700.0 * k + rng.uniform(0, 120)
        base = min(base, base_cap * (0.75 + 0.25 * ((k * 7919) % 97) / 97.0))
        if kind == 0:
            protos.append(lambda dur, b=base: chirp(b, b * (2.2 + 0.2 * (b % 3)), dur))
        elif kind == 1:
            protos.append(lambda dur, b=base: warble(b * 1.5, 7.0 + (b % 5), b * 0.25, dur))
        else:
            protos.append(lambda dur, b=base: stack([b, b * 1.9, b * 2.7], dur))
    return protos


def make_corpus(
    out_dir: str | Path,
    n_clips: int = 12,
    n_motifs: int = 3,
    occurrences_per_clip: int = 2,
    clip_seconds: float = 3.0,
    motif_seconds: tuple[float, float] = (0.25, 0.5),
    sample_rate: int = 16_000,
    noise_db: float = -30.0,
    seed: int = 0,
) -> list[Occurrence]:
    """Write `n_clips` WAVs under out_dir; return ground-truth occurrences.

    Motif instances vary in duration (time-warp) so DTW has real work to do.
    """
    rng = np.random.default_rng(seed)
    protos = _motif_bank(n_motifs, sample_rate, rng)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    truth: list[Occurrence] = []
    clip_len = int(clip_seconds * sample_rate)
    noise_amp = 10.0 ** (noise_db / 20.0)

    for ci in range(n_clips):
        x = rng.normal(0.0, noise_amp, clip_len).astype(np.float64)
        # Non-overlapping slots for motif placement.
        slots = np.linspace(0, clip_len, occurrences_per_clip + 1, dtype=int)
        for oi in range(occurrences_per_clip):
            motif = int(rng.integers(0, n_motifs))
            dur = float(rng.uniform(*motif_seconds))
            m = protos[motif](dur)
            # Fade edges to avoid clicks.
            ramp = min(256, len(m) // 4)
            env = np.ones(len(m))
            env[:ramp] = np.linspace(0, 1, ramp)
            env[-ramp:] = np.linspace(1, 0, ramp)
            m = m * env * 0.7
            lo, hi = slots[oi], slots[oi + 1] - len(m)
            if hi <= lo:
                continue
            start = int(rng.integers(lo, hi))
            x[start : start + len(m)] += m
            truth.append(Occurrence(clip=ci, motif=motif, start=start, length=len(m)))
        peak = np.abs(x).max()
        if peak > 1.0:
            x = x / peak
        write_wav(out / f"clip_{ci:04d}.wav", x.astype(np.float32), sample_rate)
    # Machine-readable ground truth beside the WAVs (tools/eval_clusters.py
    # scores a discovery manifest against it).
    import json

    (out / "truth.json").write_text(
        json.dumps(
            [
                {
                    "file": f"clip_{t.clip:04d}.wav",
                    "motif": t.motif,
                    "start_sample": t.start,
                    "end_sample": t.start + t.length,
                }
                for t in truth
            ],
            indent=1,
        )
    )
    return truth
