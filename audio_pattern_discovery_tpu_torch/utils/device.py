"""The entry points' device rule: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device where torch sees no
    card raises: the port runs on the CPU only when the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch sees no CUDA card: pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU"
        )
    return device
