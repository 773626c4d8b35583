"""Device mesh and placement descriptors over a list of torch devices.

Port of ``audio_pattern_discovery_tpu/parallel/mesh.py``.  The reference's
mesh is JAX's single-controller ``Mesh`` with ``NamedSharding``s over XLA
collectives; the port's counterpart is one process driving several CUDA
devices: a grid of ``torch.device``s with axis names, a stream per device
(each device's current stream), CUDA events to order work across devices
and peer copies (``tensor.to(other)``) where JAX has ``ppermute`` and
all-gathers.  There is no process group.  A list may repeat a device
(``[cpu] * 8``, ``[cuda:0] * 4``), which is how the CPU tests and a host of
one card run the multi-device code.

Axes, as in the reference:
* "data": batch / pair-space data parallelism (AE minibatches, DTW pair
  blocks and spectrogram clip groups split over it);
* "model": optional tensor parallelism over the AE's layers' outputs
  (``models/autoencoder.py``); size 1 by default.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from audio_pattern_discovery_tpu_torch.config import ParallelConfig
from audio_pattern_discovery_tpu_torch.utils.device import resolve_devices


@dataclass(frozen=True, eq=False)
class Mesh:
    """An n-D grid of torch devices (``devices``, an object array) with one
    name per axis."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device grid with axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> list[torch.device]:
        return list(self.devices.flat)


def device_grid(devices, shape: tuple[int, ...]) -> np.ndarray:
    """``devices`` as an object array of ``shape`` (row-major)."""
    grid = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        grid[i] = d
    return grid.reshape(shape)


def make_mesh(cfg: ParallelConfig | None = None, devices=None) -> Mesh:
    """A ("data", "model") mesh over the first data * model of ``devices``
    (default: every visible card): model = ``cfg.model_axis``, data =
    ``cfg.data_axis`` where positive, else as many rows as the devices fill.
    ValueError where data * model exceeds the devices."""
    devices = resolve_devices("cuda" if devices is None else list(devices))
    n = len(devices)
    model = cfg.model_axis if cfg else 1
    data = cfg.data_axis if cfg and cfg.data_axis > 0 else n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    return Mesh(device_grid(devices[: data * model], (data, model)), ("data", "model"))


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies over ``mesh``: ``spec[i]`` names the mesh axis its
    dimension i splits over (None or absent: whole on every slot of the
    other axes), as JAX's ``NamedSharding(mesh, PartitionSpec(*spec))``."""

    mesh: Mesh
    spec: tuple[str | None, ...] = ()

    def axis_of(self, dim: int) -> str | None:
        return self.spec[dim] if dim < len(self.spec) else None


def data_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch / pair) dimension split over the data axis."""
    return Sharding(mesh, ("data",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def ae_param_sharding(mesh: Mesh, params: dict[str, torch.Tensor]) -> dict[str, Sharding]:
    """The tensor-parallel layout of the AE's parameters (a state dict):
    every 2-D weight split on its output dimension over "model" (torch's
    [out, in] dimension 0; the reference's flax kernel [in, out] on its last),
    every 1-D leaf over "model", anything else whole.  With a model axis of
    size 1 every split is one piece."""
    def spec_for(leaf: torch.Tensor) -> Sharding:
        if leaf.dim() in (1, 2):
            return Sharding(mesh, ("model",))
        return Sharding(mesh, ())

    return {name: spec_for(leaf) for name, leaf in params.items()}


def split_over(x: torch.Tensor, sharding: Sharding, dim: int, devices) -> list[torch.Tensor]:
    """The pieces of ``x`` along ``dim`` on ``devices`` (one per slot of the
    axis ``sharding`` splits ``dim`` over; ``x`` whole on each where it does
    not split it), as ``torch.tensor_split`` cuts: sizes differ by at most
    one."""
    if sharding.axis_of(dim) is None:
        return [x.to(d) for d in devices]
    return [p.to(d) for p, d in zip(torch.tensor_split(x, len(devices), dim=dim), devices)]
