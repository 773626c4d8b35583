"""The feature scaler's statistics on the card (``csrc/scaler_stats.cu``):
each bin's mean and population std, floored at 1e-6, of [n, d] fp32 frames,
bit for bit what ``FeatureScaler.fit`` gives on the same frames as a NumPy
array.

Replaces no kernel of the reference: it replaces the NumPy reductions of
``FeatureScaler.fit`` (the reference's and the port's), which NumPy runs
row after row, so a column's sum is the sequential fp32 sum.  The kernel
keeps that order, the float64 division by n and the fp32 square root, so
the standardized frames, the PCA's covariance and its latents are the host
path's bit for bit.  The wrapper launches the kernel on CUDA tensors and
counts the launch in its ``launches`` attribute.  Its plain version is
``FeatureScaler.fit``'s NumPy branch, which takes a CPU tensor's frames.
"""

from __future__ import annotations

import torch

from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import _launch


def scaler_stats(x: torch.Tensor) -> torch.Tensor:
    """[2, d] fp32 on the card of ``x`` ([n, d] fp32, contiguous, on CUDA, n
    and d >= 1): row 0 each column's mean, row 1 its population std floored
    at 1e-6."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [n, d] float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, d = x.shape
    if not (1 <= n < 2**31 and d >= 1):
        raise ValueError(f"{n} rows of {d} columns: 1 to 2**31 - 1 rows of 1 or more")
    if x.device.type != "cuda":
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    out = torch.empty((2, d), dtype=torch.float32, device=x.device)
    _launch("scaler_stats", 2, 2, x.data_ptr(), out.data_ptr(), n, d, device=x.device)
    scaler_stats.launches += 1
    return out


scaler_stats.launches = 0
