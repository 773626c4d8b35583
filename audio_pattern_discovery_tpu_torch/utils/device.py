"""The entry points' device rule: the card unless the caller asks for the CPU."""

from __future__ import annotations

import contextlib

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


def resolve_devices(device) -> list[torch.device]:
    """The devices an entry point runs over, the first the primary: a list
    (or tuple) of devices as given, a device name with no index on a card
    (``"cuda"``) every visible card, as ``jax.devices()`` lists them, and any
    other single device alone.  A list may repeat a device."""
    if isinstance(device, (list, tuple)):
        devices = [resolve_device(d) for d in device]
        if not devices:
            raise ValueError("an empty device list")
        return devices
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def on_device(dev: torch.device):
    """A context with ``dev`` the thread's current CUDA device (nothing on
    the CPU), so that kernels, events and allocations without a device
    reach ``dev``."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
