"""Multi-device DTW wavefront: one long pair's blocked DP grid split across
devices by block columns.

Port of ``audio_pattern_discovery_tpu/parallel/wavefront.py``.  The blocked
grid of ``ops/dtw_long.py`` is cut into one stripe of block columns a
device; blocks of one block anti-diagonal are independent, so at every step
each device computes the blocks of its stripe on that diagonal and hands one
[B, BLK] right column (whose last entry is the next block's corner) to its
right neighbour: a halo exchange of one diagonal a step.  Sequence a is
whole on every device and b is sharded (each device holds only its stripe's
frames), so no device holds the [S, S] cost matrix or all of b.

The reference's ``lax.scan`` over the 2*nB - 1 diagonals with a ``ppermute``
a step is here a host loop over the diagonals that enqueues, without a host
sync, for each diagonal k and device p from the last to the first: the copy
of block row k - J0_p of p-1's right columns into p's halo, and K8 on
diagonal k of p's stripe (``ops/dtw_long.LongStripe``).  The copy needs no
event of its own: torch runs a copy between two cards on the source's
current stream after that stream waits on the destination's, and makes the
destination's stream wait on the copy, so it follows p-1's diagonal k-1 and
precedes p's diagonal k.  That two-way wait holds neighbouring devices in
lockstep, one diagonal at a time; whether their diagonals overlap has not
been measured (only on one card, listed four times).  The terminal distance
is the minimum over the devices' own outputs (+inf where a stripe does not
hold the terminal cell), the reference's ``pmin``, collected on the first
device.  CPU tensors run the same loop on the plain twin.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import INF, _normalized
from audio_pattern_discovery_tpu_torch.ops.dtw_long import LongStripe
from audio_pattern_discovery_tpu_torch.parallel.mesh import Mesh


def _axis_devices(mesh: Mesh, axis: str) -> list[torch.device]:
    """The devices along ``axis`` (the first slot of every other axis)."""
    grid = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return list(grid.reshape(grid.shape[0], -1)[:, 0])


def shard_b_for_wavefront(b: torch.Tensor, mesh: Mesh, axis: str = "seq") -> list[torch.Tensor]:
    """[B, S, d] b with its sequence axis split over ``mesh[axis]``: device p's
    frames [p S/n, (p + 1) S/n) on device p."""
    devs = _axis_devices(mesh, axis)
    if b.shape[1] % len(devs):
        raise ValueError(f"{b.shape[1]} frames do not split over {len(devs)} devices")
    return [p.to(d).contiguous() for p, d in zip(torch.chunk(b, len(devs), dim=1), devs)]


def dtw_wavefront_sharded(
    a: torch.Tensor,                 # [B, S, d] (whole on every device; the DP rows)
    b,                               # [B, S, d], or shard_b_for_wavefront's stripes
    len_a: torch.Tensor,             # [B] int32
    len_b: torch.Tensor,             # [B]
    mesh: Mesh,
    *,
    axis: str = "seq",
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    block: int = 256,
) -> torch.Tensor:
    """Batched DTW with block columns sharded across ``mesh[axis]`` -> [B]
    float32 on the first device, equal bit for bit to
    ``ops.dtw_long.dtw_long_batch`` on one device (the same K8 blocks with
    the same boundaries; the plain twin's on the CPU).  ValueError where S
    is not a multiple of the block or the block columns do not divide over
    the devices, as the reference."""
    B, S, d = a.shape
    devs = _axis_devices(mesh, axis)
    n_dev = len(devs)
    BLK = min(int(block), S)
    if S % BLK:
        raise ValueError(f"padded length {S} not a multiple of block {BLK}")
    nB = S // BLK
    if nB % n_dev:
        raise ValueError(f"{nB} block-columns not divisible by {n_dev} devices")
    if normalize not in ("none", "path_len"):
        raise ValueError(f"unknown normalize {normalize!r}")
    nJl = nB // n_dev                   # block columns per device
    stripes_b = b if isinstance(b, (list, tuple)) else shard_b_for_wavefront(b, mesh, axis)
    la = len_a.to(torch.int32)
    lb = len_b.to(torch.int32)
    stripes: list[LongStripe] = []
    halos: list[torch.Tensor | None] = []
    for p, dev in enumerate(devs):
        halos.append(None if p == 0 else torch.full((B, nB, BLK), INF, device=dev))
        stripes.append(LongStripe(
            a.to(dev), stripes_b[p].to(dev), la.to(dev), lb.to(dev), block=BLK, J0=p * nJl,
            nJ=nJl, b_off=p * nJl * BLK, halo=halos[p], metric=metric, band=band,
            auto_widen=auto_widen))
    for k in range(2 * nB - 1):
        for p in reversed(range(n_dev)):
            s = stripes[p]
            J0 = p * nJl
            if not J0 <= k < s.n_diag:
                continue
            I = k - J0
            if p > 0 and I < nB:
                halos[p][:, I].copy_(stripes[p - 1].V[:, I], non_blocking=True)
            s.advance(k, k + 1)
    out = torch.stack([s.out.to(devs[0]) for s in stripes]).amin(0)
    return _normalized(out, la.to(devs[0]), lb.to(devs[0]), normalize)
