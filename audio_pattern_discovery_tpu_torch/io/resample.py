"""Rational polyphase resampling for mixed-rate corpora (SURVEY.md SS3
row 1 boundary: window/hop are in SAMPLES, so every clip must reach the
configured rate before framing or its time/frequency axes are wrong).

Host-side by design: discovery corpora downsample far more often than they
upsample (44.1/48 kHz field recordings -> a 16-22 kHz analysis rate), and on
this backend host->device bandwidth is the measured bottleneck (BASELINE.md)
— resampling BEFORE upload ships fewer bytes, whereas a device resampler
would ship the full-rate signal first.  The compute is a one-off FIR pass
per clip through scipy's compiled upfirdn; the filter design is ours
(Kaiser-windowed sinc) and cached per rate pair.

Copy of ``audio_pattern_discovery_tpu/io/resample.py``; only the import paths differ.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np


def polyphase_filter(up: int, down: int, half_zero_crossings: int = 10,
                     beta: float = 5.0) -> np.ndarray:
    """Kaiser-windowed-sinc anti-aliasing FIR for a rational up/down stage.

    Cutoff at the tighter of the two Nyquists (1/max(up, down) in
    upsampled-rate units), 2*half_zero_crossings*max_rate+1 taps, DC gain
    `up` (each input sample spreads over `up` branches).
    """
    if up < 1 or down < 1:
        raise ValueError(f"up={up}, down={down} must be >= 1")
    max_rate = max(up, down)
    half_len = half_zero_crossings * max_rate
    n = np.arange(-half_len, half_len + 1, dtype=np.float64)
    fc = 1.0 / max_rate                       # fraction of upsampled Nyquist
    h = fc * np.sinc(fc * n)
    h *= np.kaiser(2 * half_len + 1, beta)
    h /= h.sum()                              # H(0) = 1
    return (h * up).astype(np.float64)


@lru_cache(maxsize=32)
def _cached_filter(up: int, down: int) -> np.ndarray:
    return polyphase_filter(up, down)


def resampled_length(n: int, rate_from: int, rate_to: int) -> int:
    """Output length of resample() — needed by header-only planners."""
    if rate_from == rate_to:
        return n
    g = gcd(rate_to, rate_from)
    up, down = rate_to // g, rate_from // g
    return -(-n * up // down)                 # ceil(n * up / down)


def resample(x: np.ndarray, rate_from: int, rate_to: int) -> np.ndarray:
    """float32 [n] samples at rate_from -> float32 [m] at rate_to."""
    if rate_from == rate_to:
        return x
    if rate_from < 1 or rate_to < 1:
        raise ValueError(f"rates must be positive: {rate_from} -> {rate_to}")
    from scipy.signal import upfirdn

    g = gcd(rate_to, rate_from)
    up, down = rate_to // g, rate_from // g
    h = _cached_filter(up, down)
    n_out = resampled_length(len(x), rate_from, rate_to)
    # Center the output on the filter's group delay: pre-pad h (upsampled
    # domain) until the delay is a whole number of OUTPUT samples, then
    # drop exactly that many.  Tail-pad if the trailing edge would starve
    # the last output sample (only for pathologically short inputs).
    half = (len(h) - 1) // 2
    n_pre_pad = down - half % down
    n_pre_remove = (half + n_pre_pad) // down
    hp = np.concatenate([np.zeros(n_pre_pad), h])
    y = upfirdn(hp, np.asarray(x, np.float64), up=up, down=down)
    while len(y) < n_pre_remove + n_out:
        hp = np.concatenate([hp, np.zeros(1)])
        y = upfirdn(hp, np.asarray(x, np.float64), up=up, down=down)
    return y[n_pre_remove : n_pre_remove + n_out].astype(np.float32)
