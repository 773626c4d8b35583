"""The benchmark's inputs, made from ``--seed``: frozen copies of
``chip_smoke.config4_corpus`` and of the port's ``synthetic.make_corpus``
(with its 16-bit WAV writer), so that later changes to the program cannot
change what the benchmark feeds it."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch


def config4_corpus(K: int, S: int, d: int, seed: int, dev):
    """Features [K, S, d] (zero past each length) and lengths in [S/2, S],
    made on the device in two calls of a generator seeded with ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(S // 2, S + 1, (K,), generator=g, device=dev, dtype=torch.int32)
    feats = torch.randn((K, S, d), generator=g, device=dev)
    feats *= (torch.arange(S, device=dev)[None, :, None] < lens[:, None, None])
    return feats, lens


def write_wav(path: Path, samples: np.ndarray, sample_rate: int) -> None:
    """Mono float samples in [-1, 1] as 16-bit PCM WAV."""
    x = np.asarray(samples, dtype=np.float64)
    pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    Path(path).write_bytes(hdr + pcm)


def read_wav_pcm16(path: Path) -> tuple[np.ndarray, int]:
    """(raw int16 samples, sample rate) of a mono 16-bit PCM WAV that
    ``write_wav`` wrote."""
    raw = Path(path).read_bytes()
    rate = struct.unpack_from("<I", raw, 24)[0]
    (n,) = struct.unpack_from("<I", raw, 40)
    return np.frombuffer(raw, dtype="<i2", count=n // 2, offset=44), rate


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


def make_corpus(out_dir: Path, n_clips: int, n_motifs: int, occurrences_per_clip: int,
                clip_seconds: float, motif_seconds: tuple[float, float], sample_rate: int,
                noise_db: float, seed: int) -> list[Path]:
    """Write ``n_clips`` WAVs of planted motifs in noise under ``out_dir``
    (``clip_0000.wav``, ...), the draws of ``synthetic.make_corpus``; returns
    their paths."""
    rng = np.random.default_rng(seed)
    protos = _motif_bank(n_motifs, sample_rate, rng)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    clip_len = int(clip_seconds * sample_rate)
    noise_amp = 10.0 ** (noise_db / 20.0)
    paths = []
    for ci in range(n_clips):
        x = rng.normal(0.0, noise_amp, clip_len).astype(np.float64)
        slots = np.linspace(0, clip_len, occurrences_per_clip + 1, dtype=int)
        for oi in range(occurrences_per_clip):
            motif = int(rng.integers(0, n_motifs))
            dur = float(rng.uniform(*motif_seconds))
            m = protos[motif](dur)
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
        peak = np.abs(x).max()
        if peak > 1.0:
            x = x / peak
        paths.append(out / f"clip_{ci:04d}.wav")
        write_wav(paths[-1], x.astype(np.float32), sample_rate)
    return paths
