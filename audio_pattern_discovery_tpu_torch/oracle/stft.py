"""NumPy oracle for the windowed-FFT spectrogram (SURVEY.md SS3 row 2).

Frame -> window -> rFFT -> |.|^power -> optional log10.  Frames are cut
without centering/padding (reference-style streaming frames: frame t covers
samples [t*hop, t*hop + win)).
"""

from __future__ import annotations

import numpy as np


def window_fn(name: str, win_length: int) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    if name == "hann":
        return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)
    if name == "hamming":
        return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)
    if name == "rect":
        return np.ones(win_length, dtype=np.float64)
    raise ValueError(f"unknown window {name!r}")


def num_frames(n_samples: int, win_length: int, hop_length: int) -> int:
    if n_samples < win_length:
        return 0
    return 1 + (n_samples - win_length) // hop_length


def mel_filterbank_oracle(
    n_bins: int,
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """[n_bins, n_mels] float64 triangular HTK-mel filterbank, peak 1.

    Deliberately loop-based and written independently of the vectorized
    device-side builder (ops/spectrogram.mel_filterbank) so transcription
    bugs in either cannot cancel out in the parity tests.
    """
    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    top = (n_bins - 1) * sample_rate / n_fft
    hi_edge = min(top, fmax if fmax is not None else sample_rate / 2.0)
    pts = np.array([hz(m) for m in np.linspace(mel(fmin), mel(hi_edge), n_mels + 2)])
    fb = np.zeros((n_bins, n_mels), dtype=np.float64)
    for b in range(n_mels):
        lo, c, hi_ = pts[b], pts[b + 1], pts[b + 2]
        for k in range(n_bins):
            f = k * sample_rate / n_fft
            if lo < f <= c and c > lo:
                fb[k, b] = (f - lo) / (c - lo)
            elif c < f < hi_ and hi_ > c:
                fb[k, b] = (hi_ - f) / (hi_ - c)
            elif f == lo == c:
                fb[k, b] = 1.0
    return fb


def mel_oracle(
    spec_linear: np.ndarray,       # [n_frames, n_bins] LINEAR power/magnitude
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    log_scale: bool = True,
    log_floor: float = 1e-10,
) -> np.ndarray:
    """[n_frames, n_mels] float64 (log-)mel spectrogram."""
    fb = mel_filterbank_oracle(
        spec_linear.shape[1], sample_rate, n_fft, n_mels, fmin, fmax
    )
    m = np.asarray(spec_linear, np.float64) @ fb
    if log_scale:
        m = np.log10(np.maximum(m, log_floor))
    return m


def mfcc_oracle(
    spec_linear: np.ndarray,
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    n_mfcc: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    log_floor: float = 1e-10,
) -> np.ndarray:
    """[n_frames, n_mfcc] float64 MFCCs (orthonormal DCT-II of log-mel)."""
    logmel = mel_oracle(
        spec_linear, sample_rate, n_fft, n_mels, fmin, fmax,
        log_scale=True, log_floor=log_floor,
    )
    n = n_mels
    out = np.zeros((logmel.shape[0], n_mfcc), dtype=np.float64)
    for j in range(n_mfcc):
        basis = np.cos(np.pi * (2.0 * np.arange(n) + 1.0) * j / (2.0 * n))
        scale = np.sqrt(1.0 / n) if j == 0 else np.sqrt(2.0 / n)
        out[:, j] = scale * (logmel @ basis)
    return out


def stft_oracle(
    signal: np.ndarray,
    win_length: int = 1024,
    hop_length: int = 256,
    window: str = "hann",
    n_fft: int | None = None,
    power: float = 2.0,
    log_scale: bool = True,
    log_floor: float = 1e-10,
) -> np.ndarray:
    """Returns [n_frames, n_fft//2+1] float64 spectrogram."""
    signal = np.asarray(signal, dtype=np.float64)
    n_fft = n_fft or win_length
    w = window_fn(window, win_length)
    nf = num_frames(len(signal), win_length, hop_length)
    out = np.zeros((nf, n_fft // 2 + 1), dtype=np.float64)
    for t in range(nf):
        frame = signal[t * hop_length : t * hop_length + win_length] * w
        spec = np.fft.rfft(frame, n=n_fft)
        mag = np.abs(spec)
        out[t] = mag if power == 1.0 else mag**power
    if log_scale:
        out = np.log10(np.maximum(out, log_floor))
    return out
