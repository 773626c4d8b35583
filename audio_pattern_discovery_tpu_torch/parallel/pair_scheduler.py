"""All-pairs DTW: tiled and per-pair scheduling over one device.

Port of ``audio_pattern_discovery_tpu/parallel/pair_scheduler.py``.
``all_pairs_distances`` sends a job to the tiled scheduler
(``all_pairs_distances_tiled``, the default) or, with ``tiled=False``, to the
per-pair scheduler.  The tiled routes are each a tile-pair kernel of
``ops/dtw_cuda.py`` (the CUDA kernel on a CUDA device, its plain twin on the
CPU):

- ``"diag"`` (``band_mode="diag"``): K1 ``dtw_tile_lane_diag_pairs``, classes
  from ``make_tile_lane_diag_class_fn``, long side on DP rows;
- ``"widen"`` (``band_mode="widen"``): classes from
  ``make_tile_stripe_class_fn``, each launched on K4 ``dtw_tile_lane_pairs``
  or K5 ``dtw_tile_stripe_pairs`` by the card's own gate (``widen_kernel``);
- ``"tile"`` (``band=None``, padded length <= 256): K2 ``dtw_tile_pairs``,
  classes from ``make_tile_pair_class_fn``;
- ``"full"`` (``band=None``, 256 < padded length <= 4096): K3
  ``dtw_tile_lane_full_pairs``, classes from ``make_tile_lane_full_class_fn``.

No tiled route takes an unbanded or widen job past 4096 frames:
``route_for`` sends those to the per-pair scheduler (``"per_pair"``), as the
reference's tiled gates do.  The diag route takes every length: K1 holds a
class's whole stripe per thread in shared memory, so the scheduler halves
the tile size until K1 takes the job's widest class (``_tile_classes``).

Kept from the reference: the length sort, the padding of the corpus to
whole tiles and of the time axis to a multiple of 128, the per-tile-pair
static classes with thin classes merged by ``_merge_thin_classes``,
power-of-two chunking of each class, and the fused native scatter with
``path_len`` normalization on a worker thread.  The TPU's VMEM/SMEM gates
of the routes are not ported; the widen route's K4/K5 gate is the card's
own, per class.

The per-pair scheduler is the reference's legacy loop: pairs bucketed by
length (``enumerate_pair_blocks``), gathered per block, K6
(``dtw_batch_pallas``) or K7 (``_dtw_batch_stripe``) for widen and unbanded
blocks, and K8 (``ops/dtw_long.dtw_long_pairs``, the blocked wavefront)
for every other bucket: on the CPU the plain ``ops/dtw.dtw_batch`` takes
the diag blocks up to ``MAX_KERNEL_SEQ_LEN`` instead (as the reference's
XLA path does; it has no kernel there).  K8's buckets past that length are
enumerated in the reference's blocks of at most 512 pairs but
run as one merged call over all of a job's K8 pairs (each pair on its own
grid, at most 63 launches at 8,192 frames); other blocks padded to a power
of two, a window of blocks in flight, and ``D += D.T``.

Both schedulers also keep the reference's index reuse and failure
handling: ``known=(k_old, D_old)`` takes the distances among the first
k_old sequences from a prior run and computes only the pairs that touch a
new one; ``block_dir`` persists each dispatched block as an ``.npz`` and a
rerun reads it back instead of dispatching it (``_block_key``: the block's
pair indices, the DTW config and a fingerprint of the features, so a block
is never reused after either changes); ``max_retries`` re-dispatches a block
whose launch or collection raised, from its inputs.  Block keys depend on
the chunking and so on ``ti`` (``DEFAULT_TI``): blocks written on the card
do not resume a CPU run, nor the other way round.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from audio_pattern_discovery_tpu_torch import native
from audio_pattern_discovery_tpu_torch.config import DTWConfig
from audio_pattern_discovery_tpu_torch.ops.dtw import dtw_batch
from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
    MAX_KERNEL_SEQ_LEN,
    STRIP_ROWS,
    _dtw_batch_stripe,
    _strip_lanes,
    diag_class_bounds,
    dtw_batch_pallas,
    dtw_tile_lane_diag_pairs,
    dtw_tile_lane_full_pairs,
    dtw_tile_lane_pairs,
    dtw_tile_pairs,
    dtw_tile_stripe_pairs,
    frame_layout,
    pallas_supported,
    scan_len_diff_classes,
    stripe_frame,
    strip_channels,
    strip_layout,
    tile_rep_lengths,
)
from audio_pattern_discovery_tpu_torch.ops.dtw_long import (
    dtw_long_pairs,
    gram_layout,
    long_block_shape,
    long_boundary_bytes,
)
from audio_pattern_discovery_tpu_torch.utils.device import resolve_device

# The per-pair kernels' wrappers of a block's call (K6, K7): a block's device
# time goes to the one whose launch counter its call moved.  K8's merged
# calls are timed as ``dtw_long_batch``.
_PER_PAIR_KERNELS = (dtw_batch_pallas, _dtw_batch_stripe)
# The device bytes of K8's boundaries (H, V and corners) one merged call of
# the per-pair scheduler may hold: 16,384 pairs of 8,192 frames (64 KiB a
# pair at blocks of 256); a job past it runs as several merged calls.
LONG_BOUNDARY_BUDGET = 1 << 30
# Past this matrix size, blocks assemble per sorted row strip instead of
# scattering straight into original-order D (reference: measured on the
# host, per-block random-row writes degrade superlinearly past ~2 GB).
_DIRECT_SCATTER_BYTES = 2 * 1024**3

# Tile size per device type.  On the card one tile row is one block of ti
# threads; on the CPU the plain twin pays for every padded pair and for
# the wider classes of bigger tiles, so tiles are small.  D does not depend
# on ti: every class contract is exact.
DEFAULT_TI = {"cuda": 128, "cpu": 16}

# Unbanded routes by padded length (reference: tile_geometry covers S <= 256,
# MAX_STRIPE_SEQ_LEN = 4096 caps the full-width lane kernel).
TILE_MAX_LEN = 256
FULL_MAX_LEN = 4096


def padded_len(L: int) -> int:
    """The time axis padded to a multiple of 128, as the reference pads it."""
    return 128 * -(-int(L) // 128)


def _with_retries(fn: Callable, max_retries: int, pending_exc: BaseException):
    """Re-run ``fn`` up to max_retries times after an initial failure
    (the reference's contract): ``pending_exc``, the exception that
    triggered the retry, is raised as it is when max_retries < 1, and the
    last retry's failure propagates."""
    if max_retries < 1:
        raise pending_exc
    for attempt in range(max_retries):
        try:
            return fn()
        except Exception:
            if attempt == max_retries - 1:
                raise
    raise AssertionError("unreachable")


def _block_key(ii: np.ndarray, jj: np.ndarray, cfg_tag: bytes = b"") -> str:
    """Resume key: pair indices + the DTW config fingerprint, so blocks
    persisted under one metric/band/normalization are never reused after a
    config change (the reference's key)."""
    h = hashlib.sha1(ii.tobytes() + b"|" + jj.tobytes() + b"|" + cfg_tag)
    return f"block_{ii[0]}_{jj[0]}_{len(ii)}_{h.hexdigest()[:16]}"


def _cfg_tag(cfg: DTWConfig, features, lengths: np.ndarray) -> bytes:
    """DTW config + a feature fingerprint (the reference's): shapes,
    lengths, and a 64-row stride of the feature tensor, so blocks are also
    invalidated when upstream config changes the features.  A tensor's
    stride is hashed as its float32 host copy."""
    h = hashlib.sha1(
        repr(
            (cfg.metric, cfg.band, cfg.auto_widen_band, cfg.normalize,
             cfg.dtype, cfg.band_mode)
        ).encode()
    )
    h.update(repr(tuple(features.shape)).encode())
    h.update(np.ascontiguousarray(lengths).tobytes())
    step = max(1, features.shape[0] // 64)
    sample = features[::step]
    if isinstance(sample, torch.Tensor):
        sample = sample.detach().to("cpu", torch.float32).numpy()
    h.update(np.ascontiguousarray(sample).tobytes())
    return h.hexdigest().encode()


def _check_known(known, K: int) -> None:
    k_old, D_old = known
    if not (0 <= k_old <= K and np.shape(D_old) == (k_old, k_old)):
        raise ValueError(
            f"known: D_old shape {np.shape(D_old)} != ({k_old}, {k_old}) "
            f"or k_old {k_old} out of range for K={K}"
        )


def route_for(L: int, cfg: DTWConfig) -> str:
    """The tiled route of a job with sequences padded to L frames: the
    tile-pair routes "diag" (K1), "widen" (K4 and K5), "tile" (K2) and
    "full" (K3), or "per_pair" for unbanded and widen jobs past
    FULL_MAX_LEN frames, where no tiled route applies (the reference's
    gates).  ``dtw.dtype`` does not enter: ``all_pairs_distances`` sends a
    bfloat16 job per pair itself."""
    if cfg.band is not None and cfg.band_mode == "diag":
        return "diag"
    Lp = padded_len(L)
    if Lp > FULL_MAX_LEN:
        return "per_pair"
    if cfg.band is not None:
        return "widen"
    return "tile" if Lp <= TILE_MAX_LEN else "full"


def _k1_fits(band: int, wv: int, ti: int, d: int) -> bool:
    """Whether K1 launches a class of half-width level ``wv`` at tile size
    ``ti`` and frame width ``d``: its stripe of 2*max(band, wv)+2 floats a
    thread within one block's shared memory (``_strip_lanes``)."""
    try:
        _strip_lanes(ti, stripe_frame(band, wv)[2], strip_channels(d), STRIP_ROWS)
    except ValueError:
        return False
    return True


def _tile_plan(lengths: np.ndarray, ti: int, known) -> tuple[np.ndarray, np.ndarray, list]:
    """The tiled scheduler's sequence order ``perm`` (by length; under
    ``known`` the old sequences first, each group by length), the lengths
    in that order padded to whole tiles of ``ti`` (pad entries 1), and the
    upper tile-pairs to compute: under ``known`` those with a new sequence
    on either side (the others are all in D_old; pad positions are never
    new)."""
    K = len(lengths)
    if known is None:
        perm = np.argsort(lengths, kind="stable").astype(np.int64)
    else:
        k_old = known[0]
        perm = np.concatenate([
            np.argsort(lengths[:k_old], kind="stable"),
            k_old + np.argsort(lengths[k_old:], kind="stable"),
        ]).astype(np.int64)
    nT = -(-K // ti)
    lens_p = np.ones((nT * ti,), np.int32)
    lens_p[:K] = lengths[perm]
    pairs = [(i, j) for i in range(nT) for j in range(i, nT)]
    if known is not None:
        pos_new = np.zeros(nT * ti, bool)
        pos_new[:K] = perm >= known[0]
        tile_new = pos_new.reshape(nT, ti).any(axis=1)
        pairs = [(i, j) for i, j in pairs if tile_new[i] or tile_new[j]]
    return perm, lens_p, pairs


def _tile_classes(route: str, lengths: np.ndarray, Lp: int, cfg: DTWConfig, ti: int, d: int,
                  known) -> tuple[int, np.ndarray, np.ndarray, list, dict]:
    """The tiled plan of a job on ``route``: (ti, perm, lens_p, tile-pairs,
    tile-pairs by class, thin classes merged).  The diag route puts each
    tile-pair's longer tile on the DP rows: the corridor's per-row
    half-width is then exactly ``band``, and the class stripes stay narrow
    (with the short side on rows they grow with the length ratio).  Sorted
    tiles make J >= I the longer tile; under ``known`` a new tile can be
    shorter than an old one, so the tiles' longest real lengths decide (the
    scatter writes both triangles of every block, so (J, I) blocks land like
    (I, J) ones; K2-K5 keep the A tile on rows: their class keys bound both
    orientations).  K1 holds a class's whole stripe per thread in shared memory: where the
    widest class does not fit at ``ti``, the diag route halves ti (tiles of
    more even lengths give narrower classes, and fewer lanes a block more
    room each) until it does; ValueError where it fits at no ti."""
    K = len(lengths)
    while True:
        perm, lens_p, pairs = _tile_plan(lengths, ti, known)
        nT = len(lens_p) // ti
        if route == "diag":
            pair_class = make_tile_lane_diag_class_fn(lens_p, nT, ti, Lp, int(cfg.band), K)
            tmax = [int(lens_p[t * ti : min((t + 1) * ti, K)].max()) for t in range(nT)]
            pairs = [(j, i) if tmax[j] >= tmax[i] else (i, j) for i, j in pairs]
        elif route == "widen":
            pair_class = make_tile_stripe_class_fn(
                lens_p, nT, ti, Lp, int(cfg.band), cfg.auto_widen_band, K,
            )
        elif route == "tile":
            pair_class = make_tile_pair_class_fn(lens_p, nT, ti, Lp, cfg.band, cfg.auto_widen_band)
        else:
            pair_class = make_tile_lane_full_class_fn(lens_p, nT, ti, Lp, K)
        by_class: dict[tuple[int, ...], list[tuple[int, int]]] = {}
        for pij in pairs:
            by_class.setdefault(pair_class(*pij), []).append(pij)
        _merge_thin_classes(by_class)
        if route != "diag" or all(_k1_fits(int(cfg.band), c[1], ti, d) for c in by_class):
            return ti, perm, lens_p, pairs, by_class
        if ti == 1:
            raise ValueError(
                f"a diag class of half-width {max(c[1] for c in by_class)} does not fit "
                "one K1 block's shared memory at any tile size"
            )
        ti //= 2


# The widest class stripe (2*wv+2 slots) that K4 takes; wider classes go to
# K5.  Measured on the H100 (chip_smoke.py --crossover, PERF.md section 6),
# K4 time over K5 time on one job per stripe: 0.17-0.23 at 34-144 slots
# (S=128), 0.48 at 258 (S=256), 0.76 at 258 and 0.93 at 322 (S=512); 1.26
# at 386, 1.11 at 450 and 1.37 at 514 (S=512), 1.32-4.22 at 386-1026
# (S=1024).  Both walk each pair's own band in strips; K4 keeps a thread's
# class stripe in shared memory, which caps its residency as the stripe
# grows, K5 a warp's boundary row.  320 is the ladder's last width at or
# below 322.
LANE_MAX_W = 320


def widen_kernel(wv_cls: int) -> Callable:
    """The card's own K4/K5 gate for one widen class of half-width
    ``wv_cls`` (the reference gates whole jobs on TPU VMEM/SMEM instead)."""
    return dtw_tile_lane_pairs if 2 * int(wv_cls) + 2 <= LANE_MAX_W else dtw_tile_stripe_pairs


def _ws_width(wv: int) -> int:
    """K4 class stripe width (16-multiple) covering half-widths <= wv."""
    return 16 * -(-(2 * int(wv) + 2) // 16)


def _ws_level(wv_req: int) -> int:
    """Quantize a required half-width UP to its K4 class level (7, 15, 23,
    ...)."""
    return (_ws_width(wv_req) - 2) // 2


def _ws_level_diag(wv_req: int) -> int:
    """Quantize a required half-width UP on the 8-slot width grid
    (W = 8*ceil((2*wv+2)/8); levels 7, 11, 15, 19, 23, ...), so a job has a
    handful of stripe classes."""
    w = 8 * -(-(2 * int(wv_req) + 2) // 8)
    return (w - 2) // 2


def make_tile_lane_diag_class_fn(
    lens_sorted: np.ndarray,   # [nT*ti] lengths in tile order (pad: 1)
    nT: int,
    ti: int,
    Lp: int,
    band: int,
    n_real: int,
) -> Callable[[int, int], tuple[int, int]]:
    """(I, J) tile-pair -> (rows_cls, wv_cls) for the diag lane kernel.

    wv comes from diag_class_bounds over the tile-pair's REAL length ranges
    (pad entries excluded), quantized UP by _ws_level_diag; rows is the A
    tile's max real length on a Lp//8 ladder.  Both are >=-monotone
    contracts, so _merge_thin_classes' elementwise-max merging stays
    correct.  The reference's third key component (kmax) sized TPU-only
    levers and is dropped."""
    tmin = np.empty(nT, np.int64)
    tmax = np.empty(nT, np.int64)
    for t in range(nT):
        real = lens_sorted[t * ti : min((t + 1) * ti, n_real)]
        if len(real) == 0:
            real = lens_sorted[t * ti : (t + 1) * ti]
        tmin[t], tmax[t] = real.min(), real.max()
    rq = max(16, Lp // 8)

    def pair_class(i: int, j: int) -> tuple[int, int]:
        rows_cls = min(Lp, rq * -(-int(tmax[i]) // rq))
        wv_req, _ = diag_class_bounds(
            band, int(tmin[i]), int(tmax[i]), int(tmin[j]), int(tmax[j])
        )
        return rows_cls, _ws_level_diag(min(wv_req, Lp))

    return pair_class


def make_tile_stripe_class_fn(
    lens_sorted: np.ndarray,   # [nT*ti] lengths in tile order (pad: 1)
    nT: int,
    ti: int,
    Lp: int,
    band: int,
    auto_widen: bool,
    n_real: int,
) -> Callable[[int, int], tuple[int, int]]:
    """(I, J) tile-pair -> (rows_cls, wv_cls) for K4 and K5: the reference's
    function with its K4 ladder (``_ws_level``); the reference's 128-slot
    K5 ladder is a TPU lane width, and the port's K5 sizes its shared memory
    by the class, so both kernels share the 16-slot ladder.

    rows covers the A tile's max REAL length on a Lp//8 ladder; wv is the
    widened half-width bound over both orientations, quantized UP.  Tile
    ranges exclude pad entries (``n_real``): pads (length 1) would widen the
    last tile's classes to ~Lp, and pad pairs' +inf outputs are never
    scattered.  Both components are >=-monotone contracts, so
    _merge_thin_classes stays correct."""
    tmin = np.empty(nT, np.int64)
    tmax = np.empty(nT, np.int64)
    for t in range(nT):
        real = lens_sorted[t * ti : min((t + 1) * ti, n_real)]
        if len(real) == 0:
            real = lens_sorted[t * ti : (t + 1) * ti]
        tmin[t], tmax[t] = real.min(), real.max()
    rq = max(16, Lp // 8)

    def pair_class(i: int, j: int) -> tuple[int, int]:
        rows_cls = min(Lp, rq * -(-int(tmax[i]) // rq))
        wv_req = int(band)
        if auto_widen:
            wv_req = max(wv_req, int(tmax[j]) - int(tmin[i]), int(tmax[i]) - int(tmin[j]))
        return rows_cls, _ws_level(min(wv_req, Lp))

    return pair_class


def make_tile_pair_class_fn(
    lens_sorted: np.ndarray,   # [nT*ti] lengths in tile order (pad: 1)
    nT: int,
    ti: int,
    Lp: int,
    band: int | None,
    auto_widen: bool,
) -> Callable[[int, int], tuple[int, int]]:
    """(I, J) tile-pair -> (rows_cls, scan_cls) for the square tile kernel
    (exact port of the reference).

    rows covers the A tile's max length (the length sort makes A the
    shorter side) on a Lp//8 ladder; scan_cls is the reference's banded
    scan depth (full_scan for band=None), a contract of the TPU's row scan
    that the port's K2 accepts and does not need.  The widening bound is
    taken over both orientations, as in the reference."""
    tmin = np.array([lens_sorted[t * ti : (t + 1) * ti].min() for t in range(nT)])
    tmax = np.array([lens_sorted[t * ti : (t + 1) * ti].max() for t in range(nT)])
    full_scan = max(1, (Lp - 1).bit_length())
    small_scan = min(6, full_scan)
    rq = max(16, Lp // 8)

    def pair_class(i: int, j: int) -> tuple[int, int]:
        rows_cls = min(Lp, rq * -(-int(tmax[i]) // rq))
        if band is None:
            scan_cls = full_scan
        else:
            wv_req = int(band)
            if auto_widen:
                wv_req = max(wv_req, int(tmax[j]) - int(tmin[i]), int(tmax[i]) - int(tmin[j]))
            need = max(1, (2 * min(wv_req, Lp)).bit_length())
            scan_cls = small_scan if need <= small_scan else full_scan
        return rows_cls, scan_cls

    return pair_class


def make_tile_lane_full_class_fn(
    lens_sorted: np.ndarray,   # [nT*ti] lengths in tile order (pad: 1)
    nT: int,
    ti: int,
    Lp: int,
    n_real: int,
) -> Callable[[int, int], tuple[int, int]]:
    """(I, J) tile-pair -> (rows_cls, width_cls) for the full-width lane
    kernel (exact port of the reference): rows covers the A tile's max REAL
    length, width the B tile's, each quantized UP on the Lp//8 ladder.  Both
    are >=-monotone contracts, so _merge_thin_classes stays correct."""
    tmax = np.empty(nT, np.int64)
    for t in range(nT):
        real = lens_sorted[t * ti : min((t + 1) * ti, n_real)]
        if len(real) == 0:
            real = lens_sorted[t * ti : (t + 1) * ti]
        tmax[t] = real.max()
    rq = max(16, Lp // 8)

    def pair_class(i: int, j: int) -> tuple[int, int]:
        rows_cls = min(Lp, rq * -(-int(tmax[i]) // rq))
        width_cls = min(Lp, rq * -(-int(tmax[j]) // rq))
        return rows_cls, width_cls

    return pair_class


def _merge_thin_classes(
    by_class: dict[tuple[int, ...], list],
    min_programs: int = 16,
    max_merge_cost: int = 400_000,
) -> None:
    """Merge classes with few tile-pairs into neighbours, in place (port of
    the reference's rule, kept so a job launches a handful of chunk shapes).

    The merged class takes the elementwise max of its keys, which every
    kernel contract accepts; the target minimizes the crude cost model
    programs * rows * (3 + wv), and a merge that would add more than
    ``max_merge_cost`` model units is refused."""

    def t(cls, n):
        r, s = cls[0], cls[1]
        return n * r * (3 + s + sum(cls[2:]))

    while len(by_class) > 1:
        thin = [c for c in by_class if len(by_class[c]) < min_programs]
        if not thin:
            return
        best = None  # (cost, small, target)
        for small in thin:
            for other in by_class:
                if other == small:
                    continue
                m = tuple(map(max, small, other))
                cost = (
                    t(m, len(by_class[small]))
                    - t(small, len(by_class[small]))
                    + t(m, len(by_class[other]))
                    - t(other, len(by_class[other]))
                )
                if best is None or cost < best[0]:
                    best = (cost, small, other)
        if best[0] > max_merge_cost:
            return
        _, small, target = best
        m = tuple(map(max, small, target))
        merged = by_class.pop(small) + by_class.pop(target)
        by_class.setdefault(m, []).extend(merged)


def all_pairs_distances_tiled(
    features: np.ndarray | torch.Tensor,   # [K, L, d] padded segment features
    lengths: np.ndarray,                   # [K] true frame counts
    cfg: DTWConfig,
    *,
    device: torch.device | str = "cuda",
    ti: int | None = None,
    chunk_programs: int = 64,
    stats: dict | None = None,
    lane: bool | None = None,
    stripe: bool | None = None,
    known: tuple[int, np.ndarray] | None = None,
    block_dir: str | Path | None = None,
    max_retries: int = 1,
) -> np.ndarray:
    """Symmetric [K, K] DTW matrix through the tile-pair kernels of the
    job's route (``route_for``).  On the widen route ``widen_kernel`` picks
    K4 or K5 per class; ``lane=True`` or ``stripe=True`` forces K4 or K5 for
    every class, as the reference's overrides force its kernels.  On the
    diag route ``ti`` is halved until K1 takes the widest class
    (``_tile_classes``); ``stats["ti"]`` is the tile size used.

    Sequences are length-sorted and padded to whole tiles, uploaded once,
    and every upper-triangle tile-pair runs as one kernel tile-pair (ti*ti
    pairs).  Tile-pairs are grouped by static class and launched in chunks
    of ``chunk_programs``; on a CUDA device up to eight chunks are in flight
    while a worker thread scatters finished blocks into D.

    ``known=(k_old, D_old)``: the distances among the first k_old sequences
    come from D_old.  The sort groups old sequences before new ones (each
    group length-sorted), and tile-pairs with no new sequence are skipped;
    the one boundary tile recomputes its old x old pairs with the same
    kernels.  Tiles are then not globally length-sorted (a new tile can be
    shorter than an old one): every class function bounds both
    orientations, and the diag route puts each tile-pair's longer tile on
    the DP rows.  ``block_dir``: each chunk's raw blocks persist as an
    ``.npz`` under a key of its tile-pairs, class, kernel, DTW config and
    feature fingerprint, and a chunk whose file exists is read back and
    never dispatched.  ``max_retries``: a chunk whose launch or collection
    raises is launched again from its inputs up to this many times (0: the
    first exception propagates).

    ``stats`` receives the route, host seconds per activity (dispatch,
    collect: waiting for a chunk's copy, scatter, persist, upload), the
    chunks read back (``blocks_resumed``), whether the native scatter ran
    and with OpenMP, and, on a CUDA device, ``kernel_s``: the kernel
    launches' device time from CUDA events around each launch, and
    ``kernel_s_by``: that time per kernel entry name.
    The default device is the card; without one, pass ``device="cpu"``."""
    device = resolve_device(device)
    K, L, d = features.shape
    route = route_for(L, cfg)
    if route == "per_pair":
        raise ValueError(
            f"no tiled route takes {'unbanded' if cfg.band is None else 'widen-banded'} DTW "
            f"of {L} frames (the tile-pair kernels end at {FULL_MAX_LEN}): use the per-pair "
            "scheduler (all_pairs_distances(tiled=None or False))"
        )
    lengths = np.asarray(lengths, dtype=np.int32)
    if known is not None:
        _check_known(known, K)
    forced = None
    if lane is not None or stripe is not None:
        use_lane = bool(lane) if lane is not None else not stripe
        if route != "widen" or (stripe is not None and bool(stripe) == use_lane):
            raise ValueError(
                f"lane={lane}, stripe={stripe}: these pick one widen kernel, K4 or K5 "
                f"(this job's route is {route!r})"
            )
        forced = dtw_tile_lane_pairs if use_lane else dtw_tile_stripe_pairs
    if K < 2:
        return np.zeros((K, K), dtype=np.float32)
    Lp = padded_len(L)
    ti, perm, lens_p, pairs_list, by_class = _tile_classes(
        route, lengths, Lp, cfg, int(ti or DEFAULT_TI[device.type]), d, known,
    )
    Kp = len(lens_p)
    # Updates scatter straight into D (the reference's rule): skipped
    # tile-pairs would leave row strips incomplete.
    direct = known is not None or K * K * 4 <= _DIRECT_SCATTER_BYTES
    D = np.zeros((K, K), dtype=np.float32)
    if known is not None:
        k_old, D_old = known
        D[:k_old, :k_old] = D_old
    nT = Kp // ti

    t_up = time.perf_counter()
    if isinstance(features, torch.Tensor):
        feats = features.to(device=device, dtype=torch.float32)[
            torch.as_tensor(perm, device=device)
        ]
        feats_p = torch.zeros((Kp, Lp, d), dtype=torch.float32, device=device)
        feats_p[:K, :L] = feats
    else:
        fp = np.zeros((Kp, Lp, d), np.float32)
        fp[:K, :L] = features[perm]
        feats_p = torch.from_numpy(fp).to(device)
    lens_dev = torch.from_numpy(lens_p).to(device)
    rep_dev = None
    if route == "diag":
        rep_dev = torch.from_numpy(tile_rep_lengths(lens_p, nT, ti, K)).to(device)
    # K1 and K2 read the corpus in their strip layout, K3 in the frame layout,
    # each built once a job (the CPU twins read the corpus as it is).
    frames = None
    if device.type == "cuda":
        if route == "full":
            frames = frame_layout(feats_p, cfg.metric)
        elif route in ("diag", "tile"):
            frames = strip_layout(feats_p, ti, cfg.metric)
        torch.cuda.synchronize(device)
    upload_s = time.perf_counter() - t_up

    n_pairs = K * (K - 1) // 2
    if known is not None:
        n_pairs -= k_old * (k_old - 1) // 2

    def kernel_of(cls: tuple[int, ...]) -> Callable:
        if route == "diag":
            return dtw_tile_lane_diag_pairs
        if route == "widen":
            return forced or widen_kernel(cls[1])
        return dtw_tile_pairs if route == "tile" else dtw_tile_lane_full_pairs

    def launch(ii: torch.Tensor, jj: torch.Tensor, cls: tuple[int, ...]) -> torch.Tensor:
        if route == "diag":
            return dtw_tile_lane_diag_pairs(
                feats_p, lens_dev, rep_dev, ii, jj, ti=ti, band=int(cfg.band),
                wv_max=cls[1], metric=cfg.metric, rows=cls[0], frames=frames,
            )
        if route == "widen":
            kernel = kernel_of(cls)
            return kernel(
                feats_p, lens_dev, ii, jj, ti=ti, band=int(cfg.band), wv_max=cls[1],
                auto_widen=cfg.auto_widen_band, metric=cfg.metric, rows=cls[0],
                frames=widen_frames[kernel],
            )
        if route == "tile":
            return dtw_tile_pairs(
                feats_p, lens_dev, ii, jj, ti=ti, band=cfg.band,
                auto_widen=cfg.auto_widen_band, metric=cfg.metric, rows=cls[0],
                scan_steps=cls[1], frames=frames,
            )
        return dtw_tile_lane_full_pairs(
            feats_p, lens_dev, ii, jj, ti=ti, width=cls[1], metric=cfg.metric, rows=cls[0],
            frames=frames,
        )

    # Each class's tail chunk is padded to the next power of two by
    # repeating its last tile-pair (duplicate scatters are skipped).
    chunks: list[tuple[np.ndarray, np.ndarray, tuple[int, ...]]] = []
    for cls, plist in sorted(by_class.items()):
        for s in range(0, len(plist), chunk_programs):
            part = plist[s : s + chunk_programs]
            u = 1 << max(0, (len(part) - 1).bit_length())
            while len(part) < min(u, chunk_programs):
                part = part + [part[-1]]
            chunks.append((
                np.array([p[0] for p in part], np.int32),
                np.array([p[1] for p in part], np.int32),
                cls,
            ))
    # The widen route's layouts, built once a job for the kernels its classes
    # take: K4's strip layout, K5's frame layout (on the CPU too, where the
    # wrappers check them and run the twin).
    t_up = time.perf_counter()
    widen_frames: dict[Callable, torch.Tensor] = {}
    if route == "widen":
        for kernel in {kernel_of(cls) for _, _, cls in chunks}:
            widen_frames[kernel] = (strip_layout(feats_p, ti, cfg.metric)
                                    if kernel is dtw_tile_lane_pairs
                                    else frame_layout(feats_p, cfg.metric))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    upload_s += time.perf_counter() - t_up
    if stats is None:
        stats = {}
    stats.update(
        route=route, dispatch_s=0.0, collect_s=0.0, scatter_s=0.0, persist_s=0.0, kernel_s=0.0,
        kernel_s_by={}, upload_s=upload_s, blocks=len(chunks), blocks_resumed=0, pairs=n_pairs,
        tiled=True, tile_programs=len(pairs_list), tile_classes=len(by_class), ti=ti,
    )
    if block_dir is not None:
        block_dir = Path(block_dir)
        block_dir.mkdir(parents=True, exist_ok=True)
        cfg_tag = _cfg_tag(cfg, features, lengths) + f"|tiled|{route}".encode()

    norm = cfg.normalize == "path_len"
    ls_f = lens_p.astype(np.float32)
    use_native = native.available() and os.environ.get("APD_NO_NATIVE_SCATTER", "") != "1"
    stats["native_scatter"] = use_native
    stats["native_openmp"] = bool(use_native and native.openmp)
    inv = None if direct else np.argsort(perm)
    strip_bufs: dict[int, np.ndarray] = {}
    strip_left: dict[int, int] = {}

    def _strip_buf(I):
        buf = strip_bufs.get(I)
        if buf is None:
            buf = np.zeros((min(ti, K - I * ti), K), np.float32)
            strip_bufs[I] = buf
            strip_left[I] = nT      # one piece per tile of the strip
        return buf

    def _strip_dec(I):
        strip_left[I] -= 1
        if strip_left[I] == 0:
            del strip_left[I]
            buf = strip_bufs.pop(I)
            rows = perm[I * ti : I * ti + buf.shape[0]]
            if use_native:
                native.strip_unpermute(buf, inv, rows, D)
            else:
                D[rows] = np.take(buf, inv, axis=1)

    def scatter_chunk(ii, jj, blocks) -> None:
        # Both triangles per block; diagonal tiles take their strict upper
        # part mirrored, so D is exactly symmetric with a zero diagonal.
        seen = set()
        for u in range(len(ii)):
            I, J = int(ii[u]), int(jj[u])
            if (I, J) in seen:
                continue
            seen.add((I, J))
            blk = blocks[u]
            r0, c0 = I * ti, J * ti
            # pad sequences (sorted index >= K) exist only in the last tile
            nr, nc = min(ti, K - r0), min(ti, K - c0)
            lr = ls_f[r0 : r0 + nr] if norm else None
            lc = ls_f[c0 : c0 + nc] if norm else None
            if use_native and direct:
                native.scatter_block_direct(
                    blk, nr, nc, lr, lc, perm[r0 : r0 + nr],
                    perm[c0 : c0 + nc], D, I == J,
                )
                continue
            if use_native:
                bufI = _strip_buf(I)
                bufJ = None if I == J else _strip_buf(J)
                native.scatter_block_strip(blk, nr, nc, lr, lc, bufI, c0, bufJ, r0)
                _strip_dec(I)
                if I != J:
                    _strip_dec(J)
                continue
            blk = blk[:nr, :nc] / (lr[:, None] + lc[None, :]) if norm else blk[:nr, :nc]
            if I == J:
                blk = np.triu(blk, k=1)
                blk = blk + blk.T
            if direct:
                r_orig, c_orig = perm[r0 : r0 + nr], perm[c0 : c0 + nc]
                D[np.ix_(r_orig, c_orig)] = blk
                if I != J:
                    D[np.ix_(c_orig, r_orig)] = blk.T
            else:
                _strip_buf(I)[:, c0 : c0 + nc] = blk
                _strip_dec(I)
                if I != J:
                    _strip_buf(J)[:, r0 : r0 + nr] = blk.T
                    _strip_dec(J)

    scatter_q: queue.Queue = queue.Queue(maxsize=8)
    scatter_err: list[BaseException] = []

    def scatter_worker():
        while True:
            item = scatter_q.get()
            if item is None:
                return
            if scatter_err:
                continue  # drain so the producer never blocks on put()
            try:
                ii, jj, host, events, name, dispatch, path = item
                t0 = time.perf_counter()
                try:
                    if events is not None:
                        events[2].synchronize()
                        secs = events[0].elapsed_time(events[1]) / 1e3
                        stats["kernel_s"] += secs
                        by = stats["kernel_s_by"]
                        by[name] = by.get(name, 0.0) + secs
                    vals = host.numpy()
                except Exception as exc:
                    vals = _with_retries(lambda: dispatch().cpu().numpy(), max_retries, exc)
                stats["collect_s"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                scatter_chunk(ii, jj, vals)
                stats["scatter_s"] += time.perf_counter() - t0
                if path is not None:
                    t0 = time.perf_counter()
                    np.savez(path, ii=ii, jj=jj, blocks=vals)
                    stats["persist_s"] += time.perf_counter() - t0
            except BaseException as exc:
                scatter_err.append(exc)

    worker = threading.Thread(target=scatter_worker, name="apd-scatter", daemon=True)
    worker.start()
    on_cuda = device.type == "cuda"
    try:
        for ii, jj, cls in chunks:
            if scatter_err:
                raise scatter_err[0]
            name = kernel_of(cls).__name__
            path = None
            if block_dir is not None:
                tag = cfg_tag + f"|{name}|{'|'.join(map(str, cls))}".encode()
                path = block_dir / (_block_key(ii, jj, tag) + ".npz")
                if path.exists():
                    with np.load(path) as saved:
                        resumed = (saved["ii"], saved["jj"], torch.from_numpy(saved["blocks"]))
                    stats["blocks_resumed"] += 1
                    scatter_q.put((*resumed, None, name, None, None))
                    continue

            def dispatch(ii=ii, jj=jj, cls=cls) -> torch.Tensor:
                return launch(torch.from_numpy(ii).to(device), torch.from_numpy(jj).to(device),
                              cls)

            t0 = time.perf_counter()
            events = None
            if on_cuda:
                events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                events[0].record()
            try:
                blocks = dispatch()
            except Exception as exc:
                blocks = _with_retries(dispatch, max_retries, exc)
            if on_cuda:
                events[1].record()
                host = torch.empty(blocks.shape, dtype=torch.float32, pin_memory=True)
                host.copy_(blocks, non_blocking=True)
                events.append(torch.cuda.Event())
                events[2].record()
            else:
                host = blocks
            stats["dispatch_s"] += time.perf_counter() - t0
            # The bounded queue keeps at most 8 chunks between launch and
            # scatter, so pinned buffers stay bounded.
            scatter_q.put((ii, jj, host, events, name, dispatch, path))
    finally:
        scatter_q.put(None)
        worker.join()
    if scatter_err:
        raise scatter_err[0]
    if strip_bufs:
        raise RuntimeError("incomplete row strips after all chunks")
    return D


def all_pairs_distances(
    features: np.ndarray | torch.Tensor,   # [K, L, d] padded segment features
    lengths: np.ndarray,                   # [K] true frame counts
    cfg: DTWConfig,
    *,
    device: torch.device | str = "cuda",
    stats: dict | None = None,
    tiled: bool | None = None,
    bucket_step: int = 32,
    block_dir: str | Path | None = None,
    known: tuple[int, np.ndarray] | None = None,
    max_retries: int = 1,
) -> np.ndarray:
    """Symmetric [K, K] DTW distance matrix over all segment pairs.

    ``tiled=None``: the tiled scheduler where a tile-pair route takes the
    job, else the per-pair scheduler (``route_for`` decides, as the
    reference's gates do: unbanded and widen jobs past 4096 frames go per
    pair), and the per-pair scheduler for every ``dtw.dtype=bfloat16`` job
    (the reference's ``tiled`` gate: its tile kernels run fp32 only).
    ``tiled=True``: the tiled scheduler, which raises ``ValueError`` where
    no tiled route applies; forced on a bfloat16 job it runs the job in
    fp32, as the reference's tile kernels do.  ``tiled=False``: the per-pair scheduler
    (``all_pairs_distances_per_pair``), the reference's legacy path.
    ``block_dir``: persist each block for crash resume.  ``max_retries``: a
    block whose dispatch or collection raises is dispatched again up to this
    many times before the error propagates.  ``known=(k_old, D_old)``: the
    first k_old sequences' pairwise distances come from D_old (a prior run
    over the same features); only pairs touching a new sequence are
    computed.  The default device is the card; without one, pass
    ``device="cpu"``."""
    kw = dict(device=device, stats=stats, block_dir=block_dir, known=known,
              max_retries=max_retries)
    if tiled is None:
        tiled = cfg.dtype != "bfloat16" and route_for(features.shape[1], cfg) != "per_pair"
    if tiled is False:
        return all_pairs_distances_per_pair(features, lengths, cfg, bucket_step=bucket_step, **kw)
    return all_pairs_distances_tiled(features, lengths, cfg, **kw)


def bucket_lengths(lengths: np.ndarray, step: int, max_len: int) -> np.ndarray:
    """Smallest multiple of ``step`` >= each length (capped at max_len)."""
    b = np.minimum(-(-lengths // step) * step, max_len)
    return np.maximum(b, step)


def enumerate_pair_blocks(
    lengths: np.ndarray,
    pair_batch: int,
    bucket_step: int,
    max_len: int,
    band: int | None = None,
    auto_widen: bool = True,
    new_from: int | None = None,
):
    """Yield (row_cap, bucket_len, max_len_diff, ii, jj) blocks covering the
    upper triangle (exact port of the reference).  ``new_from``: only pairs
    with at least one index >= new_from are emitted (the pairs among the
    first new_from sequences are known to the caller).

    Every pair is oriented shorter-first (ii the shorter sequence).  Pairs
    are bucketed by the longer side's padded length and sub-bucketed by the
    shorter side's (at most two row capacities per column bucket), then
    grouped by their |len_i - len_j| routing class
    (``scan_len_diff_classes``), whose bound is the emitted
    ``max_len_diff``.  Order: column bucket, row bucket, class ascending;
    pairs in the row-major order of each length-sorted group pair."""
    lengths = np.asarray(lengths)
    buckets = bucket_lengths(lengths, bucket_step, max_len)
    order = np.argsort(lengths, kind="stable").astype(np.int32)
    b_sorted = buckets[order]
    uniq = [int(b) for b in np.unique(buckets)]
    groups = {b: order[b_sorted == b] for b in uniq}

    for bb in uniq:
        gb = groups[bb]
        half = min(bb, max(bucket_step, -(-(bb // 2) // bucket_step) * bucket_step))
        classes = scan_len_diff_classes(bb, band, auto_widen)
        for ba in uniq:
            if ba > bb:
                break
            ga = groups[ba]
            rb = half if (ba <= half < bb) else bb
            if ba == bb:
                n = len(gb)
                if n < 2:
                    continue
                counts = np.arange(n - 1, 0, -1)
                iu = np.repeat(np.arange(n - 1, dtype=np.int32), counts)
                ju = np.concatenate([np.arange(i + 1, n, dtype=np.int32) for i in range(n - 1)])
                ii, jj = gb[iu], gb[ju]
            else:
                if not (len(ga) and len(gb)):
                    continue
                ii = np.repeat(ga, len(gb))
                jj = np.tile(gb, len(ga))
            if new_from is not None:
                keep = (ii >= new_from) | (jj >= new_from)
                if not keep.any():
                    continue
                ii, jj = ii[keep], jj[keep]
            if len(classes) == 1:
                splits = [(int(classes[0]), ii, jj)]
            else:
                dd = lengths[jj] - lengths[ii]                 # >= 0
                cls = np.searchsorted(np.asarray(classes), dd)
                splits = []
                for c, bound in enumerate(classes):
                    m = cls == c
                    if m.any():
                        splits.append((int(bound), ii[m], jj[m]))
            for bound, ic, jc in splits:
                for s in range(0, len(ic), pair_batch):
                    yield rb, bb, bound, ic[s : s + pair_batch], jc[s : s + pair_batch]


def all_pairs_distances_per_pair(
    features: np.ndarray | torch.Tensor,   # [K, L, d] padded segment features
    lengths: np.ndarray,                   # [K] true frame counts
    cfg: DTWConfig,
    *,
    device: torch.device | str = "cuda",
    bucket_step: int = 32,
    stats: dict | None = None,
    known: tuple[int, np.ndarray] | None = None,
    block_dir: str | Path | None = None,
    max_retries: int = 1,
) -> np.ndarray:
    """Symmetric [K, K] DTW matrix through the per-pair scheduler (port of
    the reference's legacy loop in ``all_pairs_distances``).

    Blocks from ``enumerate_pair_blocks`` gather their pairs on the device
    and run ``_dtw_block``'s routing: widen and unbanded blocks go to
    ``dtw_batch_pallas`` (K6, or K7 where the stripe applies; their twins on
    the CPU), and every other bucket to K8 (on the CPU, diag blocks up to
    MAX_KERNEL_SEQ_LEN to the plain ``ops/dtw.dtw_batch``).  Under
    ``dtw.dtype=bfloat16`` K6 and K7 stay fp32 (the reference's Pallas
    kernels take no matmul dtype), and ``dtw_batch`` and K8 take the bf16
    Gram costs (``matmul_dtype="bfloat16"``; K8's Gram instantiation on the
    card, on the corpus's ``gram_layout``).  K8's buckets past
    MAX_KERNEL_SEQ_LEN are enumerated in blocks of at most 512 pairs (the
    reference's cap).  Its blocks stay the units of ``block_dir``,
    ``known=`` and ``stats["blocks"]``, but are not dispatched one by one:
    the blocks not resumed run after the others are dispatched, as merged
    ``dtw_long_pairs`` calls on the corpus's ``frame_layout`` (built once),
    each pair unpadded on its own grid of blocks of
    ``long_block_shape(bucket)`` (at least 32 frames), as few calls as keep
    each call's boundaries under ``LONG_BOUNDARY_BUDGET`` bytes, and each
    call's distances split back per block.  Other blocks are padded to a
    power of two with self-pairs of sequence 0 (discarded).  Up to ten
    blocks are in flight, each pair lands in one triangle, and ``D += D.T``
    closes the matrix.  The kernels normalize inside, so the scatter does
    not.

    ``known=(k_old, D_old)``: only pairs touching a sequence >= k_old are
    enumerated (``new_from``), and D_old fills the old block after the
    symmetrization.  ``block_dir``: each block's distances persist as an
    ``.npz``; a block whose file exists is read back, never dispatched.
    ``max_retries``: a block (or a merged K8 call) whose dispatch or
    collection raises is dispatched again from its indices up to this many
    times.

    ``stats`` receives the block, resumed-block, pad-pair and merged K8 call
    (``long_calls``) counts, host seconds per activity (enumerate, dispatch,
    collect: waiting for a block's values, scatter, persist) and, on a CUDA
    device, from CUDA events around each block and around each merged
    call's launches: ``gather_s``, the device time of the blocks' gathers
    (K8 gathers nothing), ``kernel_s``, that of the DTW calls, and
    ``kernel_s_by``, the latter per entry name: the wrapper whose launch
    counter the call moved (``dtw_batch_pallas`` for K6,
    ``_dtw_batch_stripe`` for K7), ``dtw_long_batch`` for K8's merged
    calls.  The
    default device is the card; without one, pass ``device="cpu"``."""
    device = resolve_device(device)
    K, L, d = features.shape
    lengths = np.asarray(lengths, dtype=np.int32)
    if known is not None:
        _check_known(known, K)
    D = np.zeros((K, K), dtype=np.float32)
    if K < 2:
        return D
    diag = cfg.band is not None and cfg.band_mode == "diag"
    mm_dtype = "bfloat16" if cfg.dtype == "bfloat16" else None
    step = min(bucket_step, L) if cfg.length_bucketing else L
    if isinstance(features, torch.Tensor):
        feats_dev = features.to(device=device, dtype=torch.float32)
    else:
        feats_dev = torch.from_numpy(np.ascontiguousarray(features, dtype=np.float32)).to(device)
    lens_dev = torch.from_numpy(lengths).to(device)
    if block_dir is not None:
        block_dir = Path(block_dir)
        block_dir.mkdir(parents=True, exist_ok=True)
        cfg_tag = _cfg_tag(cfg, features, lengths)
    # The corpus's own pair count rounded to 8, at most pair_batch; the
    # plain twins on the CPU build per-diagonal costs, so blocks stay small.
    n_all_pairs = K * (K - 1) // 2
    if known is not None:
        k_old, D_old = known
        n_all_pairs -= k_old * (k_old - 1) // 2
    B = int(min(cfg.pair_batch, max(8, -(-n_all_pairs // 8) * 8)))
    if device.type == "cpu":
        B = min(B, 1024)
    # Per-block gather budget: [B, bucket, d] operands on each side.
    gather_budget = 2 << 30
    if stats is None:
        stats = {}
    stats.update(
        route="per_pair", dispatch_s=0.0, collect_s=0.0, scatter_s=0.0, persist_s=0.0,
        enumerate_s=0.0, gather_s=0.0, kernel_s=0.0, kernel_s_by={}, blocks=0,
        blocks_resumed=0, pad_pairs=0, pairs=n_all_pairs, tiled=False, long_calls=0,
    )
    on_cuda = device.type == "cuda"

    def stripe_ok(bucket, mld) -> bool:
        """Whether K6 or K7 takes the bucket (the reference's predicate)."""
        return not diag and pallas_supported(bucket, cfg.band, cfg.auto_widen_band, mld)

    def run_block(row_cap, bucket, mld, ii, jj):
        """(the block's distances, the entry that computed them, and on a
        CUDA device events before the gather and before and after the DTW
        call)."""
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if on_cuda else []
        if events:
            events[0].record()
        a, b = feats_dev[ii, :row_cap], feats_dev[jj, :bucket]
        la, lb = lens_dev[ii], lens_dev[jj]
        kw = dict(metric=cfg.metric, band=cfg.band, auto_widen=cfg.auto_widen_band,
                  normalize=cfg.normalize)
        if stripe_ok(bucket, mld):
            fn, kw["max_len_diff"] = dtw_batch_pallas, mld
        else:
            fn, kw["band_mode"], kw["matmul_dtype"] = dtw_batch, cfg.band_mode, mm_dtype
        if events:
            events[1].record()
        counts = [k.launches for k in _PER_PAIR_KERNELS]
        vals = fn(a, b, la, lb, **kw)
        if events:
            events[2].record()
        moved = [k for k, n in zip(_PER_PAIR_KERNELS, counts) if k.launches != n]
        return vals, (moved[0] if moved else fn).__name__, events

    pending: list[tuple] = []
    # K8's blocks, not dispatched one by one: (ii, jj, persist path, block).
    long_blocks: list[tuple] = []

    def run_long(group, frames):
        """One merged K8 call over the pairs of ``group``'s blocks: (the
        distances, and on a CUDA device events around its launches alone)."""
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if on_cuda else []
        ia = np.concatenate([g[0] for g in group])
        ib = np.concatenate([g[1] for g in group])
        vals = dtw_long_pairs(feats_dev, lens_dev, ia, ib, frames=frames, metric=cfg.metric,
                              band=cfg.band, auto_widen=cfg.auto_widen_band,
                              normalize=cfg.normalize, block=group[0][3], band_mode=cfg.band_mode,
                              events=events or None, matmul_dtype=mm_dtype)
        return vals, events

    def run_long_blocks():
        """All K8 blocks as merged calls, each under ``LONG_BOUNDARY_BUDGET``
        bytes of boundaries (a block is never split), the distances split
        back per block for the scatter and ``block_dir``."""
        groups: list[list] = []
        used = 0
        for blk_args in long_blocks:
            ii, jj, _, blk = blk_args
            need = int(long_boundary_bytes(lengths[ii], lengths[jj], blk).sum())
            if not groups or blk != groups[-1][0][3] or used + need > LONG_BOUNDARY_BUDGET:
                groups.append([])
                used = 0
            groups[-1].append(blk_args)
            used += need
        # The corpus as K8 reads it, built once a job (the twin takes feats).
        frames = None
        if on_cuda:
            frames = (gram_layout(feats_dev, cfg.metric) if mm_dtype
                      else frame_layout(feats_dev, cfg.metric))
        for group in groups:
            t0 = time.perf_counter()
            try:
                vals, events = run_long(group, frames)
            except Exception as exc:
                vals, events = _with_retries(lambda: run_long(group, frames), max_retries, exc)
            stats["dispatch_s"] += time.perf_counter() - t0
            stats["long_calls"] += 1
            t0 = time.perf_counter()
            try:
                host = vals.cpu().numpy()
                if events:
                    secs = events[0].elapsed_time(events[1]) / 1e3
                    stats["kernel_s"] += secs
                    by = stats["kernel_s_by"]
                    by["dtw_long_batch"] = by.get("dtw_long_batch", 0.0) + secs
            except Exception as exc:
                host = _with_retries(lambda: run_long(group, frames)[0].cpu().numpy(),
                                     max_retries, exc)
            stats["collect_s"] += time.perf_counter() - t0
            s0 = 0
            for ii, jj, path, _ in group:
                t0 = time.perf_counter()
                D[ii, jj] = host[s0 : s0 + len(ii)]
                stats["scatter_s"] += time.perf_counter() - t0
                if path is not None:
                    t0 = time.perf_counter()
                    np.savez(path, ii=ii, jj=jj, d=host[s0 : s0 + len(ii)])
                    stats["persist_s"] += time.perf_counter() - t0
                s0 += len(ii)

    def collect_one():
        ii, jj, vals, name, events, dispatch, path = pending.pop(0)
        t0 = time.perf_counter()
        try:
            host = vals.cpu().numpy()[: len(ii)]
            if events:
                stats["gather_s"] += events[0].elapsed_time(events[1]) / 1e3
                secs = events[1].elapsed_time(events[2]) / 1e3
                stats["kernel_s"] += secs
                by = stats["kernel_s_by"]
                by[name] = by.get(name, 0.0) + secs
        except Exception as exc:
            host = _with_retries(lambda: dispatch()[0].cpu().numpy()[: len(ii)], max_retries,
                                 exc)
        stats["collect_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        D[ii, jj] = host
        stats["scatter_s"] += time.perf_counter() - t0
        if path is not None:
            t0 = time.perf_counter()
            np.savez(path, ii=ii, jj=jj, d=host)
            stats["persist_s"] += time.perf_counter() - t0

    t_enum = time.perf_counter()
    for row_cap, bucket, mld, ii_all, jj_all in enumerate_pair_blocks(
        lengths, B, step, L, band=cfg.band, auto_widen=cfg.auto_widen_band,
        new_from=None if known is None else k_old,
    ):
        cap = max(512, gather_budget // (bucket * d * 8))
        # Blocks past the per-pair kernels' ceiling that K7 does not take go
        # to K8, whose per-block work grows with the block: at most 512
        # pairs (the reference's cap, with its predicate).
        long = bucket > MAX_KERNEL_SEQ_LEN and not stripe_ok(bucket, mld)
        if long:
            cap = min(cap, 512)
        # On the card K8 also takes the shorter blocks K6 and K7 do not (diag
        # blocks), in blocks of at least 32 frames: the plain dtw_batch runs
        # on CPU tensors only.
        to_k8 = long or (on_cuda and not stripe_ok(bucket, mld))
        for s in range(0, len(ii_all), cap):
            ii, jj = ii_all[s : s + cap], jj_all[s : s + cap]
            stats["enumerate_s"] += time.perf_counter() - t_enum
            stats["blocks"] += 1
            path = None
            if block_dir is not None:
                path = block_dir / (_block_key(ii, jj, cfg_tag) + ".npz")
                if path.exists():
                    with np.load(path) as saved:
                        D[saved["ii"], saved["jj"]] = saved["d"]
                    stats["blocks_resumed"] += 1
                    t_enum = time.perf_counter()
                    continue
            if to_k8:
                long_blocks.append((ii, jj, path, max(32, long_block_shape(bucket)[0])))
                t_enum = time.perf_counter()
                continue
            B_blk = min(B, max(8, 1 << (len(ii) - 1).bit_length()))
            ii_pad = np.zeros(B_blk, dtype=np.int64)
            jj_pad = np.zeros(B_blk, dtype=np.int64)
            ii_pad[: len(ii)], jj_pad[: len(jj)] = ii, jj
            stats["pad_pairs"] += B_blk - len(ii)

            def dispatch(row_cap=row_cap, bucket=bucket, mld=mld, ii_pad=ii_pad, jj_pad=jj_pad):
                return run_block(row_cap, bucket, mld, torch.from_numpy(ii_pad).to(device),
                                 torch.from_numpy(jj_pad).to(device))

            t0 = time.perf_counter()
            try:
                vals, name, events = dispatch()
            except Exception as exc:
                vals, name, events = _with_retries(dispatch, max_retries, exc)
            stats["dispatch_s"] += time.perf_counter() - t0
            pending.append((ii, jj, vals, name, events, dispatch, path))
            if len(pending) >= 10:
                collect_one()
            t_enum = time.perf_counter()
    if long_blocks:
        run_long_blocks()
    while pending:
        collect_one()
    D += D.T
    if known is not None:
        # The old x old block was never enumerated; its distances come from
        # the prior run (after the symmetrization, so nothing doubles).
        D[:k_old, :k_old] = D_old
    return D
