"""Feature scaler of the embedders.

The reference module (``audio_pattern_discovery_tpu/models/autoencoder.py``)
also holds the dense autoencoder and its training loop; those are not
ported yet (ROADMAP.md Queue 1: "models/autoencoder.py and
utils/checkpoint.py").  ``FeatureScaler`` is ported here, alone, so it
sits where its counterpart is.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class FeatureScaler:
    """Per-bin standardization fitted on the corpus; applied before encode."""

    mean: np.ndarray   # [dim]
    std: np.ndarray    # [dim]

    @classmethod
    def fit(cls, frames: np.ndarray) -> "FeatureScaler":
        mean = frames.mean(axis=0)
        std = np.maximum(frames.std(axis=0), 1e-6)
        return cls(mean.astype(np.float32), std.astype(np.float32))

    def transform(self, frames):
        """NumPy arrays stay on the host; tensors are standardized on their
        own device."""
        if isinstance(frames, torch.Tensor):
            mean = torch.from_numpy(self.mean).to(frames.device)
            std = torch.from_numpy(self.std).to(frames.device)
            return (frames - mean) / std
        return (frames - self.mean) / self.std
