"""PCA(-whitening) frame embedder, the linear alternative to the AE.

Port of ``audio_pattern_discovery_tpu/models/pca.py``.  The O(N) work, the
[d, d] covariance scatter of the standardized frames, is one fp32
``torch.matmul`` on the device (TF32 is off: the Gram of standardized data
cancels, and reduced precision would corrupt small eigenvalues).  The
eigendecomposition is a tiny float64 NumPy solve on the host, and the
projection is one fp32 matmul on the device.

Determinism: eigenvector signs are fixed so each component's
largest-|coefficient| entry is positive; ties keep numpy.linalg.eigh's
deterministic ordering.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from audio_pattern_discovery_tpu_torch.utils.device import resolve_device


@dataclass
class PCAState:
    """Frozen linear embedding: y = ((x - mean) @ components) / scale."""

    mean: np.ndarray          # [d]     mean of the (scaled) training frames
    components: np.ndarray    # [d, k]  top-k eigenvectors, sign-fixed
    scale: np.ndarray         # [k]     sqrt(eigenvalue) if whitening, else 1
    explained: np.ndarray     # [k]     fraction of total variance per comp


def pca_state_from_numpy(mean, components, scale, explained) -> PCAState:
    """The port's state from the JAX package's ``PCAState`` fields as NumPy
    arrays (float32), so both packages project identical frames
    identically."""
    return PCAState(
        mean=np.asarray(mean, np.float32),
        components=np.asarray(components, np.float32),
        scale=np.asarray(scale, np.float32),
        explained=np.asarray(explained, np.float32),
    )


def _covariance(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and unnormalized scatter matrix of [N, d] frames (fp32)."""
    mu = torch.mean(x, dim=0)
    xc = x - mu
    return mu, torch.matmul(xc.T, xc)


def fit_pca(
    flat_scaled: np.ndarray | torch.Tensor,   # [N, d] standardized frames
    n_components: int,
    whiten: bool = True,
    eps: float = 1e-6,
    device: torch.device | str = "cuda",
) -> PCAState:
    """PCA of [N, d] standardized frames, its scatter built on ``device``
    (the card unless the caller asks for the CPU; no card raises)."""
    n, d = flat_scaled.shape
    if not 1 <= n_components <= d:
        raise ValueError(f"n_components={n_components} not in [1, {d}]")
    if n < 2:
        raise ValueError(f"need >= 2 frames to fit PCA, got {n}")
    x = torch.as_tensor(flat_scaled, dtype=torch.float32).to(resolve_device(device))
    mu_dev, s_dev = _covariance(x)
    mu = mu_dev.cpu().numpy().astype(np.float64)
    cov = s_dev.cpu().numpy().astype(np.float64) / (n - 1)
    w, v = np.linalg.eigh(cov)                       # ascending eigenvalues
    w = np.maximum(w[::-1], 0.0)                     # descending, clip noise
    v = v[:, ::-1]
    comps = v[:, :n_components]
    # Sign convention: largest-|coefficient| entry positive.
    flip = np.sign(comps[np.argmax(np.abs(comps), axis=0), np.arange(n_components)])
    flip[flip == 0] = 1.0
    comps = comps * flip[None, :]
    top_w = w[:n_components]
    scale = np.sqrt(top_w) + eps if whiten else np.ones(n_components)
    total = float(w.sum()) or 1.0
    return PCAState(
        mean=mu.astype(np.float32),
        components=comps.astype(np.float32),
        scale=scale.astype(np.float32),
        explained=(top_w / total).astype(np.float32),
    )


def encode_pca(state: PCAState, frames: torch.Tensor) -> torch.Tensor:
    """[..., d] (scaled) frames -> [..., k] embedding, one fp32 matmul on
    the device of ``frames``."""
    dev = frames.device
    mean = torch.from_numpy(state.mean).to(dev)
    comps = torch.from_numpy(state.components).to(dev)
    scale = torch.from_numpy(state.scale).to(dev)
    return torch.matmul(frames.float() - mean, comps) / scale
