"""Temporal-context stacking: spectrogram slices as embedder inputs.

Port of ``audio_pattern_discovery_tpu/ops/context.py``.
``autoencoder.context_frames = k`` feeds the embedder (AE or PCA) the
(2k+1)-frame window centred on each frame, concatenated along the feature
axis; the DTW still sees one latent per frame.

Boundary rule: offsets are clamped into the segment (``clip(t+o, 0,
len-1)``), never across segment or clip boundaries, so a segment's
embedding depends only on its own frames and incremental update/query reuse
stays sound.

The host functions are NumPy copies of the reference's; the device version
is a handful of ``torch.take_along_dim`` gathers on the resident segment
tensor, with no host round trip of the (2k+1)x inflated tensor.
"""

from __future__ import annotations

import numpy as np
import torch


def stack_context_frames(frames: np.ndarray, k: int) -> np.ndarray:
    """[n, d] -> [n, (2k+1)*d] windows with edge clamping (one segment)."""
    if k <= 0:
        return frames
    n = frames.shape[0]
    t = np.arange(n)
    cols = [frames[np.clip(t + o, 0, n - 1)] for o in range(-k, k + 1)]
    return np.concatenate(cols, axis=1)


def stack_context_host(
    seg_frames: np.ndarray,     # [K, L, d] padded segment frames
    seg_lengths: np.ndarray,    # [K]
    k: int,
) -> np.ndarray:
    """Padded-batch host stacking; pad frames (t >= len) are zeroed."""
    if k <= 0:
        return seg_frames
    K, L, d = seg_frames.shape
    t = np.arange(L, dtype=np.int64)[None, :]                       # [1, L]
    hi = np.maximum(seg_lengths.astype(np.int64), 1)[:, None] - 1   # [K, 1]
    cols = []
    for o in range(-k, k + 1):
        idx = np.clip(t + o, 0, hi)                                 # [K, L]
        cols.append(np.take_along_axis(seg_frames, idx[:, :, None], axis=1))
    out = np.concatenate(cols, axis=2)
    mask = t < seg_lengths[:, None]
    return np.where(mask[:, :, None], out, 0.0).astype(seg_frames.dtype)


def stack_context_device(
    seg_dev: torch.Tensor,      # [K, L, d] on its device
    seg_lengths: np.ndarray,    # [K]
    k: int,
) -> torch.Tensor:
    """``stack_context_host`` on the resident tensor, on its own device:
    one gather per offset over the clamped indices, then the pad mask.  The
    result is (2k+1)x the segment tensor."""
    if k <= 0:
        return seg_dev
    K, L, d = seg_dev.shape
    dev = seg_dev.device
    t = torch.arange(L, device=dev)[None, :]                              # [1, L]
    lens = torch.as_tensor(np.asarray(seg_lengths, np.int64), device=dev)[:, None]
    hi = torch.clamp(lens, min=1) - 1                                     # [K, 1]
    cols = []
    for o in range(-k, k + 1):
        idx = torch.minimum(torch.clamp(t + o, min=0), hi)                # [K, L]
        cols.append(torch.take_along_dim(seg_dev, idx[:, :, None], dim=1))
    out = torch.cat(cols, dim=2)
    return torch.where((t < lens)[:, :, None], out, torch.zeros((), dtype=seg_dev.dtype,
                                                                  device=dev))


def flat_context(
    seg_frames: np.ndarray,     # [K, L, d]
    seg_lengths: np.ndarray,    # [K]
    k: int,
) -> np.ndarray:
    """Unpadded training pool: every real frame's (2k+1)-frame slice,
    concatenated across segments in segment order."""
    parts = [
        stack_context_frames(seg_frames[s, : int(seg_lengths[s])], k)
        for s in range(seg_frames.shape[0])
    ]
    return np.concatenate(parts, axis=0)
