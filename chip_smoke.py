#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--phases 1,12,13]

Phases (each one passes or the script exits non-zero, and prints its
seconds; ``--phases`` runs a subset, phase 1 always):

1. device: a CUDA card is required; prints its name and power limit and
   builds the kernels K1-K8 (K8 with its Gram instantiations) from ``audio_pattern_discovery_tpu_torch/csrc``
   (one nvcc each, started together), with each source's registers and
   spill bytes from ``ptxas -v`` (a spill fails the phase);
2. K1 against its plain PyTorch twin on the card at the config-4 tile shape
   (d=16, S=128, band=16, lengths 64-128; euclidean on 10 tile-pairs,
   sqeuclidean and cosine on 2), at the other frame widths it is built for
   (d=4, 8, 20, 40 on 3 tile-pairs), plus an out-of-frame call that must
   come back all +inf; a diag job with length-1 sequences through the
   scheduler on the card (ti=128) and on the CPU (ti=16): the same D, and
   the length-1 pairs the oracle's; prints both times, cells/s and the share
   of the bound;
3. ``discover()`` on the seed-7 corpus against
   ``tests/golden/GOLDEN_cpu_seed7_mfcc_pca.npz`` (D at rtol 1e-4 /
   atol 1e-5, partition exact) with the K1 launch count of that run;
4. config 2 through the CLI (100 clips of 10 s at 44.1 kHz, PCA, band
   16) as a subprocess; prints wall time and stage timings;
5. config 4 through the scheduler: all pairs of K=10,240 sequences (S=128,
   d=16, band=16, lengths 64-128); prints pairs/s and launches, checks 64
   random pairs against the plain torch DTW on the card and 8 against the
   NumPy oracle; the native scatter must have run;
6. K2 against its twin on the card (S=256, d=16, ti=128, 4 tiles, lengths
   8-256): unbanded euclidean on all 10 tile-pairs, sqeuclidean, cosine and
   widen band 8 (auto_widen on and off) on 2, every strip height and frame
   width it is built for (S=128 and 256, d=4, 8, 16, 20, 40 on 2
   tile-pairs), and a ``rows`` shortfall that must be +inf on exactly the
   cut rows; prints both times, cells/s and the share of the bound;
7. K3 against its twin on the card (S=1024, d=16, ti=128, 2 tiles, lengths
   257-1024) on all 3 tile-pairs, plus a ``width`` and a ``rows``
   shortfall that must come back +inf, and on one tile-pair at S=384 at
   every frame width it is built for (d=4, 8, 20, 40) and with the other
   two metrics; prints both times, cells/s and the share of the bound;
8. config 2 through the CLI at its default DTW (no band: K2);
9. ``discover()`` on the seed-7 corpus unbanded on the card and on the
   CPU in this process: D at rtol 1e-4 / atol 1e-5, partition exact;
10. long units (24 clips of 20 s with 3-5 s motifs, segments up to 1024
   frames): K3 and the checkpointed backtrace through ``discover()``; 16
   distances against the NumPy oracle; the job's DTW again through the
   scheduler (the same D) for K3's device time and bound at this cell;
11. config 4 unbanded through the scheduler (K2); prints pairs/s, the
   kernel's device time and the scatter's seconds, checks 64 pairs against
   the plain torch DTW and 8 against the oracle; the native scatter must
   have run;
12. K4 against its twin at the config-4 widen shape (S=128, d=16, band 16,
   lengths 64-128, ti=128, 10 tile-pairs; sqeuclidean, cosine and a hard
   band on 2), plus a ``rows`` and a ``wv_max`` shortfall that must be +inf
   on exactly the cut pairs, and at every frame width it is built for (S=128
   and 256, d=4, 8, 16, 20, 40 on 3 tile-pairs);
13. K5 against its twin at a config-4 wide class (phase 12's tile-pairs,
   W=130; the three metrics and a hard band), at every frame width it is
   built for (as phase 12), and at S=1024 (d=16, lengths 257-1024, 3
   tile-pairs) with both shortfalls on one tile-pair;
14. config 4 widen (band 16) through the scheduler: each kernel must launch
   exactly as often as the classes and the K4/K5 gate predict
   (``widen_split``: every class on K4 since the gate moved to 320 slots);
   each kernel's device time and share of its cells' bound; 64 pairs
   against the plain torch DTW and 8 against the oracle; the native scatter
   must have run;
15. long units widen (band 16, phase 10's corpus, alignments off) through
   ``discover()``: the job must take K5 (K5's main-path cell); 8 distances
   against the oracle;
16. K6 and K7 against their twins on gathered pairs (S=128 and S=1024); K6
   also unbanded, with a widen band 16 and a hard band (16, or 128 at
   S=1024, where the route sends narrower ones to K7) at S=128, 256 and
   1024 (widen at S=1024 in the class only K6 takes, |la-lb| > 127), each
   at every frame width and metric, with +inf on exactly the pairs outside
   the hard band and the cut pairs of a rows shortfall; K7 on 64 pairs of
   each of the per-pair route's first two band-16 classes at every frame
   width and metric it is built for, and a hard band; both kernels'
   Euclidean costs bit for bit against the IEEE sqrt of their squared
   costs across the float range (``sqrt_rn``); K6 timed where the route
   runs it (131,072 pairs at S=128, widen and unbanded, twice; 2,048 and
   8,192 pairs at S=1024), K7 at the long per-pair job's median launch size
   (4,096 pairs); then the per-pair route ``all_pairs_distances(tiled=False)``,
   widen and unbanded, on a K=2,048 slice of the config-4 corpus and on a
   job of lengths 900-1024, each job three times: D must equal the tiled D
   (K2 or K3 unbanded), K6 must launch in the unbanded long job and K7 in
   the widen one, and each job's walls are printed beside the split of its
   median run (K6, K7, gathers, dispatch, collect, scatter);
17. the CLI on the length-varied corpus with a widen band, with
   ``--device cuda`` (K4 or K5 must launch) and with ``--device cpu``: D at
   rtol 1e-4 / atol 1e-5, partition exact;
18. the AE (the default embedder) on 65,536 seeded frames of 513 bins at the
   default widths (batch 1024, 20 epochs), trained on the card and on the
   CPU from the port's own init: losses, parameters and latents within the
   stated tolerances (``AE_*``), the same parameters encoded on both devices,
   TF32 off; again at bf16 (2 epochs); prints the train wall, steps/s, the
   fp32 bound and its share, a training call's kernel time and idle share
   under torch.profiler, and ``encode_frames``' time; a checkpoint saved
   and restored on the card encodes bit for bit;
19. config 2 through the CLI at the default config (no ``-s``: the AE and
   unbanded K2, which must launch; the loss must fall); prints the wall,
   the stages, the AE's pool, the planted-truth purity and the time of
   importing ``torch._dynamo`` (torch.optim's first use); then twice with
   ``autoencoder.checkpoint=true``: the second run restores (no epochs) and
   gives the same D bit for bit;
20. ``discover()`` on the seed-7 corpus at the default config with band 16
   (the AE and K1) on the card and on the CPU: D within ``AE_D_ATOL``,
   partition exact; again with ``autoencoder.overlap_clip_fraction=0.5``
   (the AE trained on a worker thread beside the second half's
   spectrograms): the single-phase segment table, and card vs CPU as above;
21. index reuse through the CLI at the default config (the AE, K2): 90 of
   config 2's clips indexed with ``autoencoder.checkpoint=true``, the other
   10 added with ``--update``, and a full run over all 100 from the restored
   checkpoint: D at rtol 1e-4 / atol 1e-5, partition exact, the update's K2
   launches no more and its tile-pairs fewer than the full run's; prints
   ``dtw_pairs_reused`` and each wall; then ``--query`` of a held-out clip
   (clip 100 of the same generator) with ``--top-k 5``: its wall and best
   cluster;
22. ``known=`` on the tiled route: config 4 grown by 1,024 of its 10,240
   sequences, diag (K1) and unbanded (K2), against phases 5 and 11's D
   (tile-pairs, launches, kernel seconds and walls beside the full job's,
   and whether D is bitwise equal); then a job of 384 sequences per route
   (K1, K2, K3, K4, K5) whose new sequences are shorter than the old, so
   tiles are out of length order: every chunk its kernel launches held
   against the plain twin on the card, D against the sorted full job and
   256 new pairs against the plain ``dtw_batch``;
23. ``known=`` (``new_from``) on the per-pair route: phase 16's K=2,048
   slice and its 900-1024-frame job, widen band 16 and unbanded, the first
   7/8 of each job old: D against the tiled full D, K6 and K7 launches;
24. block resume: ``discover()`` on seed 7 with
   ``parallel.checkpoint_blocks=true`` twice, and the per-pair slice with a
   ``block_dir`` twice: each second run launches no DTW kernel and gives the
   same D bit for bit;
25. ``--serve`` as a subprocess on the card: ping, ``discover`` on seed 7,
   a request that fails, the same ``query`` twice, ``doctor`` with the
   device probes, shutdown; prints the
   start-up and each request's wall; the served D equals the CLI's bit for
   bit;
26. ``autoencoder.context_frames=2`` and ``spectrogram.upload_codec=mulaw8``,
   each through ``discover()`` on seed 7 (the golden config) on the card and
   on the CPU: D at rtol 1e-4 / atol 1e-5, partition exact;
27. K8 (``dtw_long_batch``) against its plain twin on the card (``K8_RTOL``,
   the largest relative difference per check printed): 64 pairs at S=8192
   (lengths 4097-8192, block 256) unbanded, widen 16 with auto_widen on and
   off (off: +inf on exactly the pairs outside the band) and diag 16; at
   S=2048 (``K8_SWEEP_S``) the three metrics, every frame width it is built
   for (d=4, 8, 20, 40), blocks of 64 and 128 frames, each also bit for bit
   against K7 (widen 16 and a hard band 16 at S=2048) and K6 (unbanded at
   S=1024), and an out-of-frame call (+inf); two stripes of block columns
   with a halo bit for bit against the whole grid (``long_block_columns``,
   unbanded and diag 16); a single block; 8 sequences against themselves on
   4 x 4 blocks, exactly 0 (the corner between diagonal blocks); 4 pairs at
   S=16,384 with the memory beyond the inputs printed (boundaries only);
   the merged call (``dtw_long_pairs``: 40 pairs of 300-2,048 frames by
   index into one corpus) launching max(nBa + nBb - 1) times and bit for bit
   K8 pair by pair, unbanded, widen 16 and diag 16; the frame widths past
   K8's staged rings (d=64, 128, and 396, the widest one warp's A pass fits,
   and d=64 at blocks of 64) against the twin; K8's configuration and shared
   memory per CUDA block; K8 timed on the 64 pairs at d=16 and d=64, each
   beside the other choice of B's staging, and at d=16 beside one warp for
   both passes (in turns, distances bitwise equal), and at the route's
   launch size (512 pairs at bucket 8192,
   unbanded and widen 16) with its bound;
28. long units past 4096 frames through ``discover()`` (24 clips of 120 s
   with 3 motifs of 25-45 s, unbanded, PCA, alignments off): K8 alone
   launches, 8 distances against the twin, purity, the stages; the job
   again through the per-pair route (the same D and K8 launches, at most
   max(nBa + nBb - 1) a merged call) with the split of its wall; on the same
   features widen band 16 (K8) and diag band 16 on the
   tiled route (K1, at the tile size the scheduler picks) and per pair
   (K8), D bitwise equal; and the per-pair route on 64 sequences of
   1,100-4,096 frames unbanded (K8) against the tiled K3 D;
29. a diag band 16 job of mixed lengths through ``discover()`` (16 clips of
   90 s with motifs of 2-40 s): K1 alone launches, at the tile size the
   scheduler halves to, D the scheduler's bit for bit, 8 distances against
   K8's twin;
30. the runtime extras: ``--doctor`` as a subprocess (the card's name and
   power limit, ``dispatch_floor_ms``, ``hbm_gbps``, ``upload_mb_s``, and
   the eight kernel libraries current in ``compile_cache``); the seed-7 CLI
   at the golden config with ``--trace DIR``: the trace's CUDA kernel
   events of K1's kernel number the run's K1 launches; ``time_fn`` beside
   ``cuda_ms`` on one K1 call;
31. ``dtw.dtype=bfloat16``: K8's Gram instantiation against its twin
   (``K8_BF16_RTOL``) on 64 pairs at S=8192 unbanded, widen 16 and diag 16,
   and at S=2048 at d=64 and cosine, never equal to the fp32 distances; it
   and the fp32 instantiation timed in turns at 512 pairs of bucket 8192
   with their bounds (``bound_gram``: the dot product at the bf16
   tensor-core rate, the rest at the fp32 rate); ``all_pairs_distances`` on
   phase 28's features in bfloat16 (per pair, K8's Gram instantiation
   alone, its launches counted from 0), 8 pairs against the twin and the 3
   shortest segments' pairs against the CPU port; the seed-7 CLI with
   ``-s dtw.dtype=bfloat16 -s dtw.band=16`` on the card (its diag buckets
   of at most 1024 frames on K8 alone) and on the CPU: partition exact,
   ``dtw_tile_programs`` 0, the card's D within each pair's derived bound
   (``bf16_pair_bound``) of the plain ``dtw_batch`` on the CPU on the card
   run's own features, and the same job in the process, counted and timed,
   bitwise the CLI's D.

Two measurements outside the phases, each after phase 1 and then exit:
``--crossover`` times K4 against K5 on one job per class stripe, in turns
(the K4/K5 gate, ``pair_scheduler.LANE_MAX_W``); ``--against TREE`` runs
K1, K3-K7 (and K8 where a checkout has it) from this checkout and from
another (its parent, unpacked with ``git archive``) in turns, checks K1's,
K3's, K4's, K6's and K7's outputs bitwise, K8's and phase 28's unbanded D
(its features from this checkout's front end) bitwise across the runs, and
reports their times and phase 28's per-pair wall and K8 time.

Phases 5, 11 and 14 print the kernels' cells/s and share of the bound
beside their device time.  Kernel times are device times
(``utils/timer.cuda_ms``: CUDA events around calls queued behind a device
sleep, so the host's work per call does not show).  A bound is the larger
of the call's fp32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s
(the H100's published peaks): ``3d + 4`` operations for each DP cell the
distances need (``pair_cells``), ``2d + 8`` in K8's Gram instantiation.

The line before the last is a JSON object with the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``.  Everything else goes to
earlier lines.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

from audio_pattern_discovery_tpu_torch.utils.timer import cuda_ms

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "GOLDEN_cpu_seed7_mfcc_pca.npz"
PALLAS = "audio_pattern_discovery_tpu/ops/dtw_pallas.py"
CSRC = "audio_pattern_discovery_tpu_torch/csrc"
KERNELS = {   # source name -> (entry function, kernel body it replaces)
    "dtw_lane_diag": ("dtw_tile_lane_diag_pairs", f"{PALLAS}:1747"),
    "dtw_tile": ("dtw_tile_pairs", f"{PALLAS}:570"),
    "dtw_lane_full": ("dtw_tile_lane_full_pairs", f"{PALLAS}:2307"),
    "dtw_lane": ("dtw_tile_lane_pairs", f"{PALLAS}:1497"),
    "dtw_tile_stripe": ("dtw_tile_stripe_pairs", f"{PALLAS}:1060"),
    "dtw_rowscan": ("dtw_batch_pallas", f"{PALLAS}:148"),
    "dtw_stripe": ("_dtw_batch_stripe", f"{PALLAS}:261"),
    # No pallas_call: the reference's block kernel inside an XLA scan.
    "dtw_long_block": ("dtw_long_batch", "audio_pattern_discovery_tpu/ops/dtw_long.py:72"),
}
# Kernel vs plain twin: both compute each pair in fp32 from the same
# squared-difference costs; the twin evaluates each DP row's left-to-right
# chain in closed form (a running sum and a running min), which reorders
# additions by a few ulps of the row sum.  Over <=128 rows of costs ~6 that
# stays far below 1e-5 of distances in the hundreds.
K1_RTOL, K1_ATOL = 1e-5, 1e-4
# K2 and its twin add the same costs in the same order along every path
# (the twin cell by cell, the kernel along each row); they differ only in
# each cost's rounding (the order of the d-term sum, the sqrt), so a
# distance of n <= la+lb terms differs by at most (d + n) * 2^-24 relative:
# 3.2e-5 at S=256, d=16.  The atol covers cosine costs near 0.
K2_RTOL, K2_ATOL = 4e-5, 1e-4
# K3, K4, K6 and K7 walk each row cell by cell like K2 (the same bound:
# (d + n) 2^-24 relative for a path of n <= la+lb terms; 1.3e-4 at S=1024 for
# K3, K6 and K7).  K5 reassociates the additions along each DP row with a
# warp scan (the twin adds cell by cell), so each side is within n * 2^-24
# of the exact sum and the two within 2 (la+lb) * 2^-24 + d * 2^-24
# relative: 2.5e-4 at S=1024 (K3's and K6's tolerance while they had such a
# scan).
K4_RTOL, K4_ATOL = 4e-5, 1e-4
K7_RTOL, K7_ATOL = 1.5e-4, 1e-3
K3_RTOL, K3_ATOL = K7_RTOL, K7_ATOL
K6_RTOL, K6_ATOL = K7_RTOL, K7_ATOL
K5_RTOL, K5_ATOL = 2.5e-4, 1e-3


# K8 against its twin: both add every cell's cost to the min of its three
# predecessors, cell by cell, in the same order (the twin along each block's
# anti-diagonals), so they differ only in each cost's rounding (the order of
# the d-term sum; both square roots are the IEEE one).  The worst case for a
# path of n <= 2S terms is (d + 2S) 2^-24 relative (9.8e-4 at S=8192, d=16),
# but the rounding errors are independent and cancel: the largest reading
# over phases 27-29 on the H100 80GB HBM3 at 700 W was 2.0e-7 relative (a
# single block; 1.9e-7 unbanded at S=8192), and the limit is 10x that.  K8 is further held
# bit for bit against K6 (unbanded) and K7 (widen and hard band), which walk
# the same systolic chain on the same costs (``k8_witness``).
K8_RTOL = 2e-6
K8_ATOL = 1e-3     # cosine costs near 0, as K7
# K1 and K8 (diag) and K3 and K8 (unbanded) compute their costs from the same
# fmaf chain over channels 0..d-1 and the IEEE square root, and each cell as
# cost + min(min(diag, up), left): the same operations on the same values,
# so their distances are expected bitwise equal; phase 28 holds K1 and K8 to
# that, and K3 and K8 to K3's tolerance, as its twin check.

# Frame widths beside d=16 at which phases 2 and 6 hold K1 and K2 against
# their twins: 1, 2, 8 and 10 float4s a frame (strip_channels), every
# instantiation of csrc/dtw_strip.cuh's frame widths; 10 (d > 32) reads the
# strip's A frames from shared memory instead of registers.
SWEEP_DIMS = (4, 8, 20, 40)

# The card's published peaks (H100 SXM at 700 W, from NVIDIA's datasheet):
# fp32 outside the tensor cores, and device memory.
FP32_OPS_S = 67e12
HBM_BYTES_S = 3.35e12


def cell_ops(d: int) -> int:
    """fp32 operations of one Euclidean DP cell: d subtractions, d FMAs (2
    each), a sqrt, two mins and an add."""
    return 3 * d + 4


def bound(cells: float, d: int, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for the
    cells and the bytes (each input read once, each output written once)."""
    t_ops, t_bytes = cells * cell_ops(d) / FP32_OPS_S, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def pair_cells(la, lb, kind: str, band: int | None = None):
    """DP cells each pair's distance needs (int64 tensor like la): "full"
    every cell of the la x lb rectangle; "widen" |j - i| <= max(band, |la-lb|);
    "diag" the corridor |j(la-1) - i(lb-1)| <= max(band,1) max(la-1, lb-1)."""
    la, lb = la.long(), lb.long()
    if kind == "full":
        return la * lb
    total = torch.zeros_like(la)
    if kind == "widen":
        pw = torch.clamp((la - lb).abs(), min=int(band))
    else:
        den_t, num = la - 1, lb - 1
        thresh = max(int(band), 1) * torch.maximum(den_t, num)
    for i in range(int(la.max())):
        if kind == "widen":
            lo, hi = torch.clamp(i - pw, min=0), torch.minimum(lb - 1, i + pw)
        else:
            m = i * num
            lo = torch.where(den_t > 0, -torch.div(thresh - m, den_t.clamp(min=1),
                                                   rounding_mode="floor"), 0).clamp(min=0)
            hi = torch.where(den_t > 0, torch.div(m + thresh, den_t.clamp(min=1),
                                                  rounding_mode="floor"), lb - 1)
            hi = torch.minimum(hi, lb - 1)
        total += torch.where(i < la, (hi - lo + 1).clamp(min=0), 0)
    return total


def tile_call_cells(lens, ii, jj, ti: int, kind: str, band: int | None = None) -> float:
    """Cells of one tile-pair call: every (A row, B column) pair of every
    tile-pair (ii, jj)."""
    lane = torch.arange(ti, device=lens.device)
    la = lens[ii.long()[:, None] * ti + lane][:, :, None].expand(-1, ti, ti)
    lb = lens[jj.long()[:, None] * ti + lane][:, None, :].expand(-1, ti, ti)
    return float(pair_cells(la.reshape(-1), lb.reshape(-1), kind, band).sum())


def tile_call_bytes(ii, jj, ti: int, S: int, d: int) -> float:
    """Bytes of one tile-pair call: the frames and lengths of the tiles it
    touches, read once, and its [U, ti, ti] output."""
    n_tiles = len(set(ii.tolist()) | set(jj.tolist()))
    return n_tiles * ti * (S * d + 1) * 4.0 + len(ii) * ti * ti * 4.0


def pair_bytes(la, lb, d: int) -> float:
    """Bytes of one call on gathered pairs: each pair's live frames (la and
    lb of d floats; the padding past them is never read), its two lengths
    and its output."""
    return float((la.long() + lb.long()).sum()) * d * 4.0 + len(la) * 12.0


def job_cells(lens_np, kind: str, band: int | None = None) -> float:
    """Cells of all K(K-1)/2 pairs of a job, from its length histogram (the
    cell counts are symmetric in the two lengths)."""
    vals, counts = np.unique(lens_np, return_counts=True)
    la = torch.from_numpy(np.repeat(vals, len(vals)).astype(np.int64))
    lb = torch.from_numpy(np.tile(vals, len(vals)).astype(np.int64))
    cells = pair_cells(la, lb, kind, band).numpy().reshape(len(vals), len(vals))
    w = np.outer(counts, counts).astype(np.float64)
    np.fill_diagonal(w, counts * (counts - 1.0))
    return float((w * cells).sum() / 2)


def rate_line(ms: float, cells: float, bound_ms: float) -> str:
    return (f"{cells / ms * 1e3:.4g} cells/s, bound {bound_ms:.3f} ms, "
            f"{bound_ms / ms:.1%} of the bound")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def spread(times: list[float]) -> str:
    t = sorted(times)
    return f"median {t[len(t) // 2]:.3f} ms (min {t[0]:.3f}, max {t[-1]:.3f}, {len(t)} calls)"


def config4_corpus(K: int, S: int, d: int, seed: int, dev):
    """Features and lengths of the config-4 shape, made on the device."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(S // 2, S + 1, (K,), generator=g, device=dev, dtype=torch.int32)
    feats = torch.randn((K, S, d), generator=g, device=dev)
    feats *= (torch.arange(S, device=dev)[None, :, None] < lens[:, None, None])
    return feats, lens


def phase1(dev) -> dict:
    from audio_pattern_discovery_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load_all(list(KERNELS))
    log(f"phase 1: K1-K8 loaded in {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        secs, ptxas = _build.build_info.get(name, (0.0, "(already built)"))
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", ptxas)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill (?:stores|loads)", ptxas))
        log(f"  {name}.cu built in {secs:.2f} s: {len(regs)} kernel instantiations, "
            f"registers {min(regs, default=0)}-{max(regs, default=0)}, spill bytes {spills}")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    ptxas: {line.strip()}")
        if spills:
            fail(f"phase 1: {name}.cu spills {spills} bytes to local memory")
    return {}


def k1_inputs(dev, nT: int, d: int, seed: int):
    """K1's arguments on a length-sorted config-4-shape corpus (ti=128,
    S=128, lengths 64-128, band 16) for all its upper tile-pairs, long side
    on rows (as the scheduler orients them), at the class contract."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import diag_class_bounds, tile_rep_lengths

    ti, S, band = 128, 128, 16
    feats, lens = config4_corpus(ti * nT, S, d, seed=seed, dev=dev)
    order = torch.argsort(lens, stable=True)
    feats, lens = feats[order].contiguous(), lens[order].contiguous()
    lens_np = lens.cpu().numpy()
    rep = torch.from_numpy(tile_rep_lengths(lens_np, nT, ti, len(lens_np))).to(dev)
    tmin, tmax = tile_ranges(lens_np, nT, ti)
    pairs = [(j, i) for i in range(nT) for j in range(i, nT)]
    wv = max(diag_class_bounds(band, tmin[a], tmax[a], tmin[b], tmax[b])[0] for a, b in pairs)
    ii = torch.tensor([p[0] for p in pairs], dtype=torch.int32, device=dev)
    jj = torch.tensor([p[1] for p in pairs], dtype=torch.int32, device=dev)
    kw = dict(ti=ti, band=band, wv_max=wv, rows=max(tmax[a] for a, _ in pairs))
    return (feats, lens, rep, ii, jj), kw


def phase2(dev) -> dict:
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
        dtw_tile_lane_diag_pairs,
        dtw_tile_lane_diag_pairs_ref,
        strip_channels,
    )

    ti, nT, S, d, band = 128, 4, 128, 16, 16
    # All upper tile-pairs: 4 diagonal tiles and 6 cross-tile pairs, (3, 0)
    # the widest length spread.
    (feats, lens, rep, ii, jj), kw = k1_inputs(dev, nT, d, seed=1)
    wv, rows = kw["wv_max"], kw["rows"]
    n_tp = len(ii)
    got = dtw_tile_lane_diag_pairs(feats, lens, rep, ii, jj, **kw)
    torch.cuda.synchronize()
    want = dtw_tile_lane_diag_pairs_ref(feats, lens, rep, ii, jj, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        fail("phase 2: K1 returned non-finite distances inside the class contract")
    err = (got - want).abs()
    bad = ~torch.isclose(got, want, rtol=K1_RTOL, atol=K1_ATOL)
    max_abs = float(err.max())
    if bool(bad.any()):
        fail(f"phase 2: K1 disagrees with its plain twin on {int(bad.sum())} pairs "
             f"(max abs err {max_abs})")
    # The other two metrics on a diagonal and the widest cross tile-pair.
    sub_ii, sub_jj = ii[[0, 3]], jj[[0, 3]]
    for metric in ("sqeuclidean", "cosine"):
        got_m = dtw_tile_lane_diag_pairs(feats, lens, rep, sub_ii, sub_jj, metric=metric, **kw)
        want_m = dtw_tile_lane_diag_pairs_ref(feats, lens, rep, sub_ii, sub_jj,
                                              metric=metric, **kw)
        if not bool(torch.isclose(got_m, want_m, rtol=K1_RTOL, atol=K1_ATOL).all()):
            fail(f"phase 2: K1 ({metric}) disagrees with its plain twin "
                 f"(max abs err {float((got_m - want_m).abs().max())})")
    # Out of frame: B tile far longer than its (deliberately wrong)
    # representative length, at a half-width below the requirement.
    oof_lens = lens.clone()
    oof_lens[:ti] = 8
    oof_rep = rep.clone()
    oof_rep[1] = 8
    one = torch.tensor([0], dtype=torch.int32, device=dev)
    oof_args = (feats, oof_lens, oof_rep, one, one + 1)
    oof_kw = dict(ti=ti, band=2, wv_max=4, rows=8)
    oof = dtw_tile_lane_diag_pairs(*oof_args, **oof_kw)
    oof_ref = dtw_tile_lane_diag_pairs_ref(*oof_args, **oof_kw)
    if not (bool(torch.isinf(oof).all()) and bool(torch.isinf(oof_ref).all())):
        fail("phase 2: out-of-frame pairs did not come back +inf")
    # The other frame widths K1 is built for (2 tiles, all 3 tile-pairs).
    for dd in SWEEP_DIMS:
        args_d, kw_d = k1_inputs(dev, 2, dd, seed=20 + dd)
        agree(f"phase 2 (d={dd})", dtw_tile_lane_diag_pairs(*args_d, **kw_d),
              dtw_tile_lane_diag_pairs_ref(*args_d, **kw_d), K1_RTOL, K1_ATOL)
    single = single_row_job(dev)
    ms = cuda_ms(lambda: dtw_tile_lane_diag_pairs(feats, lens, rep, ii, jj, **kw), 20)
    plain_ms = cuda_ms(lambda: dtw_tile_lane_diag_pairs_ref(feats, lens, rep, ii, jj, **kw), 3)
    n_pairs = n_tp * ti * ti
    cells = tile_call_cells(lens, ii, jj, ti, "diag", band)
    bound_ms, bound_by = bound(cells, d, tile_call_bytes(ii, jj, ti, S, d))
    log(f"phase 2: K1 vs plain on {n_tp} tile-pairs ({n_pairs} pairs, W={2 * wv + 2}, "
        f"rows={rows}): max abs err {max_abs:.3g} (rtol {K1_RTOL}, atol {K1_ATOL}); "
        f"sqeuclidean and cosine agree; out-of-frame all +inf; d={SWEEP_DIMS} agree "
        f"(float4s a frame {[strip_channels(x) for x in SWEEP_DIMS]}); {single}")
    log(f"phase 2: K1 {ms:.3f} ms/call ({n_pairs / ms * 1e3:.0f} pairs/s, {cells:.4g} corridor "
        f"cells, {rate_line(ms, cells, bound_ms)}), plain {plain_ms:.3f} ms/call "
        f"({n_pairs / plain_ms * 1e3:.0f} pairs/s)")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def single_row_job(dev) -> str:
    """A diag job (band 2, unnormalized) with length-1 sequences, through the
    tiled scheduler on the card (ti=128) and on the CPU (ti=16): the same D,
    and every pair with a length-1 side the oracle's.  A length-1 A row has
    the whole of row 0 in its corridor, which K1 walks in its own branch."""
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.oracle.dtw import dtw_oracle
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import (
        all_pairs_distances_tiled,
    )

    K, S, d = 160, 64, 16
    g = torch.Generator().manual_seed(21)
    lens = torch.randint(2, S + 1, (K,), generator=g, dtype=torch.int32)
    lens[::20] = 1
    feats = torch.randn((K, S, d), generator=g)
    feats *= torch.arange(S)[None, :, None] < lens[:, None, None]
    lens_np = lens.numpy()
    cfg = DTWConfig(band=2, band_mode="diag", normalize="none")
    D = all_pairs_distances_tiled(feats.to(dev), lens_np, cfg, device=dev)
    D_cpu = all_pairs_distances_tiled(feats, lens_np, cfg, device="cpu")
    if not np.allclose(D, D_cpu, rtol=K1_RTOL, atol=K1_ATOL):
        fail(f"phase 2: the length-1 diag job differs between the card (ti=128) and the CPU "
             f"(ti=16) (max abs {np.abs(D - D_cpu).max()})")
    f_np = feats.numpy()
    ones = np.flatnonzero(lens_np == 1)
    for a in ones:
        for b in range(K):
            if b == a:
                continue
            want = dtw_oracle(f_np[a, :1], f_np[b, :lens_np[b]], band=2, band_mode="diag")
            if not np.isclose(D[a, b], want, rtol=1e-5, atol=1e-5):
                fail(f"phase 2: length-1 pair D[{a},{b}]={D[a, b]} vs oracle {want}")
    return (f"length-1 diag job (K={K}, {len(ones)} of length 1): card ti=128 vs CPU ti=16 "
            f"max abs err {np.abs(D - D_cpu).max():.3g}, {len(ones) * (K - 1)} length-1 pairs "
            f"match the oracle")


def golden_config():
    from audio_pattern_discovery_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.dtw.band = 16
    cfg.spectrogram.feature = "mfcc"
    cfg.spectrogram.n_mels = 48
    cfg.spectrogram.n_mfcc = 16
    cfg.autoencoder.method = "pca"
    cfg.autoencoder.latent_dim = 8
    cfg.output.write_snippets = False
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    return cfg


def partition(labels) -> list[tuple[int, ...]]:
    groups: dict[int, list[int]] = {}
    for i, lab in enumerate(labels):
        groups.setdefault(int(lab), []).append(i)
    return sorted(tuple(g) for g in groups.values())


def phase3(dev, tmp: Path) -> dict:
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_lane_diag_pairs
    from audio_pattern_discovery_tpu_torch.pipeline import discover
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    make_corpus(tmp / "seed7", n_clips=12, n_motifs=3, seed=7)
    dtw_tile_lane_diag_pairs.launches = 0
    t0 = time.perf_counter()
    res = discover(tmp / "seed7", golden_config(), device=dev)
    wall = time.perf_counter() - t0
    launches = dtw_tile_lane_diag_pairs.launches
    ref = np.load(GOLDEN)
    D = res.distance_matrix
    if D.shape != ref["D"].shape:
        fail(f"phase 3: D shape {D.shape} != golden {ref['D'].shape}")
    if not np.allclose(D, ref["D"], rtol=1e-4, atol=1e-5):
        fail(f"phase 3: D differs from the golden (max abs {np.abs(D - ref['D']).max()})")
    if partition(res.labels) != partition(ref["labels"]):
        fail("phase 3: cluster partition differs from the golden")
    if launches < 1:
        fail("phase 3: discover() never launched K1")
    log(f"phase 3: golden seed-7 mfcc+pca matched on the card: K={D.shape[0]}, max abs "
        f"err {np.abs(D - ref['D']).max():.3g}, {len(res.clusters)} clusters, "
        f"K1 launches {launches}, wall {wall:.2f} s")
    return {"launches": launches}


def config2_corpus(tmp: Path) -> tuple[Path, list[dict]]:
    """Config 2's corpus (100 clips of 10 s at 44.1 kHz, 5 motifs), made once
    under ``tmp``, and its planted occurrences."""
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    corpus, truth_file = tmp / "config2", tmp / "config2_truth.json"
    if not truth_file.exists():
        truth = make_corpus(corpus, n_clips=100, n_motifs=5, occurrences_per_clip=4,
                            clip_seconds=10.0, sample_rate=44_100, seed=2)
        truth_file.write_text(json.dumps([vars(o) for o in truth]))
    return corpus, json.loads(truth_file.read_text())


def cli(tag: str, corpus: Path | None, out: Path, *flags: str) -> tuple[dict, float, dict]:
    """The CLI as a subprocess (on the card unless ``flags`` say otherwise;
    no corpus argument for ``--query``): (its JSON output, wall incl.
    start-up, out's clusters.json)."""
    cmd = [sys.executable, "-m", "audio_pattern_discovery_tpu_torch",
           *([str(corpus)] if corpus is not None else []), "-o", str(out), *flags]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{tag}: CLI exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout), wall, json.loads((out / "clusters.json").read_text())


def phase4(tmp: Path) -> dict:
    corpus, _ = config2_corpus(tmp)
    summary, wall, manifest = cli("phase 4", corpus, tmp / "config2_out",
                                  "-s", "dtw.band=16", "-s", "autoencoder.method=pca")
    if manifest["n_clusters"] < 1:
        fail("phase 4: no clusters found")
    launches = int(summary["counts"].get("dtw_kernel_launches", 0))
    if launches < 1:
        fail("phase 4: the CLI run never launched K1")
    t = {k: round(v, 3) for k, v in summary["timings_s"].items()}
    log(f"phase 4: config 2 CLI (100 clips, {summary['n_segments']} segments, "
        f"{manifest['n_clusters']} clusters, K1 launches {launches}): wall "
        f"{wall:.2f} s (process incl. start-up); stages {t}")
    return {}


def phase5(dev, keep: dict) -> dict:
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_lane_diag_pairs

    cfg = DTWConfig(band=16, band_mode="diag", normalize="path_len")
    config4_all_pairs("phase 5", dev, cfg, (dtw_tile_lane_diag_pairs,), "diag", seed=5,
                      keep=keep)


def sorted_corpus(K: int, S: int, d: int, lo: int, hi: int, seed: int, dev):
    """Length-sorted features [K, S, d] (zero past each length), lengths in
    [lo, hi], made on the device."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lens, _ = torch.sort(torch.randint(lo, hi + 1, (K,), generator=g, device=dev,
                                       dtype=torch.int32))
    feats = torch.randn((K, S, d), generator=g, device=dev)
    feats *= (torch.arange(S, device=dev)[None, :, None] < lens[:, None, None])
    return feats.contiguous(), lens.contiguous()


def agree(tag: str, got, want, rtol: float, atol: float) -> float:
    """Max abs error over the finite entries; fails unless +inf sits in the
    same places and the finite entries agree."""
    inf_g, inf_w = torch.isinf(got), torch.isinf(want)
    if not bool((inf_g == inf_w).all()):
        fail(f"{tag}: +inf in {int(inf_g.sum())} kernel entries, {int(inf_w.sum())} twin entries")
    if bool(torch.isnan(got).any()):
        fail(f"{tag}: NaN in the kernel's output")
    fin = ~inf_w
    if not bool(fin.any()):
        return 0.0
    err = (got - want)[fin].abs()
    bad = ~torch.isclose(got[fin], want[fin], rtol=rtol, atol=atol)
    if bool(bad.any()):
        fail(f"{tag}: kernel and twin disagree on {int(bad.sum())} pairs "
             f"(max abs err {float(err.max())})")
    return float(err.max())


def tile_ranges(lens_np, nT: int, ti: int) -> tuple[list[int], list[int]]:
    return ([int(lens_np[t * ti:(t + 1) * ti].min()) for t in range(nT)],
            [int(lens_np[t * ti:(t + 1) * ti].max()) for t in range(nT)])


def phase6(dev) -> dict:
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
        _tile_strip_rows,
        dtw_tile_pairs,
        dtw_tile_pairs_ref,
        strip_channels,
    )

    ti, nT, S, d = 128, 4, 256, 16
    feats, lens = sorted_corpus(ti * nT, S, d, 8, 256, seed=6, dev=dev)
    _, tmax = tile_ranges(lens.cpu().numpy(), nT, ti)
    pairs = [(i, j) for i in range(nT) for j in range(i, nT)]
    ii = torch.tensor([p[0] for p in pairs], dtype=torch.int32, device=dev)
    jj = torch.tensor([p[1] for p in pairs], dtype=torch.int32, device=dev)
    kw = dict(ti=ti, rows=max(tmax))
    got = dtw_tile_pairs(feats, lens, ii, jj, **kw)
    torch.cuda.synchronize()
    want = dtw_tile_pairs_ref(feats, lens, ii, jj, **kw)
    if not bool(torch.isfinite(got).all()):
        fail("phase 6: K2 returned non-finite distances inside the class contract")
    max_abs = agree("phase 6 (euclidean)", got, want, K2_RTOL, K2_ATOL)
    # A diagonal and the widest cross tile-pair for the other metrics and
    # the widen band (+inf where the corner is out of the band).
    sub = (ii[[0, 3]], jj[[0, 3]])
    for extra in (dict(metric="sqeuclidean"), dict(metric="cosine"),
                  dict(band=8, auto_widen=True), dict(band=8, auto_widen=False)):
        agree(f"phase 6 ({extra})", dtw_tile_pairs(feats, lens, *sub, **kw, **extra),
              dtw_tile_pairs_ref(feats, lens, *sub, **kw, **extra), K2_RTOL, K2_ATOL)
    # rows shortfall on tile-pair (1, 2): +inf on exactly the A rows past it.
    rows_cut = int(torch.sort(lens[ti:2 * ti]).values[ti // 2])
    one = (ii[[5]], jj[[5]])
    cut = dtw_tile_pairs(feats, lens, *one, ti=ti, rows=rows_cut)[0]
    agree("phase 6 (rows shortfall)", cut[None],
          dtw_tile_pairs_ref(feats, lens, *one, ti=ti, rows=rows_cut), K2_RTOL, K2_ATOL)
    over = (lens[ti:2 * ti] > rows_cut)[:, None].expand_as(cut)
    if not (bool(torch.isinf(cut[over]).all()) and bool(torch.isfinite(cut[~over]).all())):
        fail("phase 6: a rows shortfall did not give +inf on exactly the cut rows")
    # Every (strip height, frame width) K2 is built for: both padded lengths
    # the scheduler sends it (R=8 past S=128), d=16 and the other widths, on
    # a cross and a diagonal tile-pair of 2 tiles.
    variants = set()
    for S_w in (128, 256):
        for dd in (d, *SWEEP_DIMS):
            f_w, l_w = sorted_corpus(ti * 2, S_w, dd, 8, S_w, seed=S_w + dd, dev=dev)
            sub_w = (torch.tensor([0, 1], dtype=torch.int32, device=dev),
                     torch.tensor([1, 1], dtype=torch.int32, device=dev))
            kw_w = dict(ti=ti, rows=int(l_w.max()))
            agree(f"phase 6 (S={S_w}, d={dd})", dtw_tile_pairs(f_w, l_w, *sub_w, **kw_w),
                  dtw_tile_pairs_ref(f_w, l_w, *sub_w, **kw_w), K2_RTOL, K2_ATOL)
            variants.add((_tile_strip_rows(S_w, strip_channels(dd)), strip_channels(dd)))
    ms = cuda_ms(lambda: dtw_tile_pairs(feats, lens, ii, jj, **kw), 10)
    plain_ms = cuda_ms(lambda: dtw_tile_pairs_ref(feats, lens, ii, jj, **kw), 1, warm=False)
    n_pairs = len(pairs) * ti * ti
    cells = tile_call_cells(lens, ii, jj, ti, "full")
    bound_ms, bound_by = bound(cells, d, tile_call_bytes(ii, jj, ti, S, d))
    log(f"phase 6: K2 vs plain on {len(pairs)} tile-pairs ({n_pairs} pairs, S={S}, "
        f"rows={kw['rows']}): max abs err {max_abs:.3g} (rtol {K2_RTOL}, atol {K2_ATOL}); "
        f"sqeuclidean, cosine and widen band 8 agree; rows shortfall +inf on "
        f"{int(over[:, 0].sum())} cut rows; (rows a strip, float4s a frame) "
        f"{sorted(variants)} agree")
    log(f"phase 6: K2 {ms:.3f} ms/call ({n_pairs / ms * 1e3:.0f} pairs/s, {cells:.4g} cells, "
        f"{rate_line(ms, cells, bound_ms)}), plain {plain_ms:.3f} ms/call "
        f"({n_pairs / plain_ms * 1e3:.0f} pairs/s)")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase7(dev) -> dict:
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
        _systolic_rows,
        dtw_tile_lane_full_pairs,
        dtw_tile_lane_full_pairs_ref,
        frame_layout,
        strip_channels,
    )

    ti, nT, S, d = 128, 2, 1024, 16
    feats, lens = sorted_corpus(ti * nT, S, d, 257, 1024, seed=7, dev=dev)
    tmin, tmax = tile_ranges(lens.cpu().numpy(), nT, ti)
    ii = torch.tensor([0, 0, 1], dtype=torch.int32, device=dev)
    jj = torch.tensor([0, 1, 1], dtype=torch.int32, device=dev)
    kw = dict(ti=ti, width=max(tmax), rows=max(tmax))
    got = dtw_tile_lane_full_pairs(feats, lens, ii, jj, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = dtw_tile_lane_full_pairs_ref(feats, lens, ii, jj, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(got).all()):
        fail("phase 7: K3 returned non-finite distances inside the class contract")
    max_abs = agree("phase 7", got, want, K3_RTOL, K3_ATOL)
    one = (ii[[1]], jj[[1]])
    # width below the B tile's longest sequences, rows below the A tile's.
    w_cut = 8 * ((tmin[1] + tmax[1]) // 16)
    r_cut = (tmin[0] + tmax[0]) // 2
    for tag, cut_kw, over in (
        ("width", dict(ti=ti, width=w_cut, rows=max(tmax)), (lens[ti:] > w_cut)[None, :]),
        ("rows", dict(ti=ti, width=max(tmax), rows=r_cut), (lens[:ti] > r_cut)[:, None]),
    ):
        cut = dtw_tile_lane_full_pairs(feats, lens, *one, **cut_kw)
        agree(f"phase 7 ({tag} shortfall)", cut,
              dtw_tile_lane_full_pairs_ref(feats, lens, *one, **cut_kw), K3_RTOL, K3_ATOL)
        over = over.expand_as(cut[0])
        if not (bool(over.any()) and bool(torch.isinf(cut[0][over]).all())
                and bool(torch.isfinite(cut[0][~over]).all())):
            fail(f"phase 7: a {tag} shortfall did not give +inf on exactly the cut pairs")
    # Every frame width K3 is built for and the other two metrics, on one
    # tile-pair of a shorter corpus (S=384, lengths 129-384: 2-3 passes of
    # 128 rows, 3-6 of 64 at 8 float4s a frame).
    variants = []
    for dd, metric in ((16, "sqeuclidean"), (16, "cosine"),
                       *((x, "euclidean") for x in SWEEP_DIMS)):
        f_s, l_s = sorted_corpus(ti, 384, dd, 129, 384, seed=70 + dd, dev=dev)
        u = torch.zeros(1, dtype=torch.int32, device=dev)
        kw_s = dict(ti=ti, width=int(l_s.max()), rows=int(l_s.max()), metric=metric)
        agree(f"phase 7 (d={dd}, {metric})", dtw_tile_lane_full_pairs(f_s, l_s, u, u, **kw_s),
              dtw_tile_lane_full_pairs_ref(f_s, l_s, u, u, **kw_s), K3_RTOL, K3_ATOL)
        variants.append((_systolic_rows(strip_channels(dd)), strip_channels(dd), metric))
    # Timed as the scheduler launches it: the corpus layout built once.
    frames = frame_layout(feats)
    ms = cuda_ms(lambda: dtw_tile_lane_full_pairs(feats, lens, ii, jj, frames=frames, **kw), 3)
    n_pairs = 3 * ti * ti
    cells = tile_call_cells(lens, ii, jj, ti, "full")
    bound_ms, bound_by = bound(cells, d, tile_call_bytes(ii, jj, ti, S, d))
    log(f"phase 7: K3 vs plain on 3 tile-pairs ({n_pairs} pairs, S={S}, width {kw['width']}): "
        f"max abs err {max_abs:.3g} (rtol {K3_RTOL}, atol {K3_ATOL}); width and rows "
        f"shortfalls +inf on exactly the cut pairs; (rows a lane, float4s a frame, metric) "
        f"{variants} agree at S=384")
    log(f"phase 7: K3 {ms:.3f} ms/call ({n_pairs / ms * 1e3:.0f} pairs/s, "
        f"{rate_line(ms, cells, bound_ms)}), plain {plain_ms:.3f} ms/call "
        f"({n_pairs / plain_ms * 1e3:.0f} pairs/s)")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase8(tmp: Path) -> dict:
    corpus, _ = config2_corpus(tmp)
    summary, wall, manifest = cli("phase 8", corpus, tmp / "config2_unbanded_out",
                                  "-s", "autoencoder.method=pca")
    if manifest["n_clusters"] < 1:
        fail("phase 8: no clusters found")
    launches = int(summary["counts"].get("launches.dtw_tile_pairs", 0))
    if launches < 1:
        fail("phase 8: the CLI run at the default DTW never launched K2")
    t = {k: round(v, 3) for k, v in summary["timings_s"].items()}
    log(f"phase 8: config 2 CLI at the default DTW (no band; 100 clips, "
        f"{summary['n_segments']} segments, {manifest['n_clusters']} clusters, K2 launches "
        f"{launches}): wall {wall:.2f} s (process incl. start-up); stages {t}")
    return {"launches": launches}


def phase9(dev, tmp: Path) -> dict:
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_pairs
    from audio_pattern_discovery_tpu_torch.pipeline import discover

    cfg = golden_config()
    cfg.dtw.band = None
    dtw_tile_pairs.launches = 0
    res = discover(tmp / "seed7", cfg, device=dev)
    launches = dtw_tile_pairs.launches
    ref = discover(tmp / "seed7", cfg, device="cpu")
    D, D_cpu = res.distance_matrix, ref.distance_matrix
    if launches < 1:
        fail("phase 9: discover() never launched K2")
    if D.shape != D_cpu.shape or not np.allclose(D, D_cpu, rtol=1e-4, atol=1e-5):
        fail(f"phase 9: the card's D differs from the CPU's (max abs {np.abs(D - D_cpu).max()})")
    if partition(res.labels) != partition(ref.labels):
        fail("phase 9: the card's cluster partition differs from the CPU's")
    log(f"phase 9: seed-7 unbanded on the card matches the CPU path: K={D.shape[0]}, max abs "
        f"err {np.abs(D - D_cpu).max():.3g}, {len(res.clusters)} clusters, K2 launches {launches}")
    return {}


def long_units_corpus(tmp: Path) -> Path:
    """24 clips of 20 s at 44.1 kHz with 3 motifs of 3-5 s (made once)."""
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    corpus = tmp / "long_units"
    if not corpus.exists():
        make_corpus(corpus, n_clips=24, n_motifs=3, occurrences_per_clip=2, clip_seconds=20.0,
                    motif_seconds=(3.0, 5.0), sample_rate=44_100, seed=10)
    return corpus


def oracle_pairs(f, n, ia, ib, **kw) -> list[float]:
    """The NumPy oracle on pairs (ia[k], ib[k]) of padded features f with
    lengths n, path_len-normalized: it walks its float64 DP cell by cell in
    Python (~3 s for a pair of 700-frame segments), so 8 worker processes
    share the pairs."""
    from audio_pattern_discovery_tpu_torch.oracle.dtw import dtw_oracle

    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(partial(dtw_oracle, normalize="path_len", **kw),
                             [f[a, :n[a]] for a in ia], [f[b, :n[b]] for b in ib]))


def phase10(dev, tmp: Path) -> dict:
    from audio_pattern_discovery_tpu_torch.config import PipelineConfig
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_lane_full_pairs
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances
    from audio_pattern_discovery_tpu_torch.pipeline import discover

    corpus = long_units_corpus(tmp)
    cfg = PipelineConfig().override({
        "segmentation.max_len_frames": 1024, "dtw.max_seq_len": 1024,
        "autoencoder.method": "pca", "output.write_images": False,
    })
    dtw_tile_lane_full_pairs.launches = 0
    t0 = time.perf_counter()
    res = discover(corpus, cfg, out_dir=tmp / "long_units_out", device=dev)
    wall = time.perf_counter() - t0
    launches = dtw_tile_lane_full_pairs.launches
    ckpt = int(res.counters.counts.get("alignments_checkpointed", 0))
    if launches < 1:
        fail("phase 10: discover() never launched K3")
    if ckpt < 1:
        fail("phase 10: no cluster was aligned through the checkpointed backtrace")
    D, f, n = res.distance_matrix, res.seg_features, res.seg_lengths
    if not np.isfinite(D).all() or len(res.clusters) < 1:
        fail("phase 10: non-finite distances or no clusters")
    rng = np.random.default_rng(10)
    ia = rng.integers(0, len(n), 16)
    ib = (ia + rng.integers(1, len(n), 16)) % len(n)
    for a, b, want in zip(ia, ib, oracle_pairs(f, n, ia, ib)):
        if not np.isclose(D[a, b], want, rtol=K3_RTOL, atol=1e-5):
            fail(f"phase 10: D[{a},{b}]={D[a, b]} vs oracle {want}")
    # The job's DTW again through the scheduler for K3's device time at this
    # cell: the same D, bitwise.
    stats: dict = {}
    D2 = all_pairs_distances(f, n, cfg.dtw, device=dev, stats=stats)
    if not np.array_equal(D, D2):
        fail("phase 10: the job's D through the scheduler differs from discover()'s")
    k3_s = stats["kernel_s_by"].get("dtw_tile_lane_full_pairs", 0.0)
    cells = job_cells(n, "full")
    k3_bound, _ = bound(cells, f.shape[2], 0.0)
    t = {k: round(v, 3) for k, v in res.counters.timings_s.items()}
    log(f"phase 10: long units ({len(n)} segments of {int(n.min())}-{int(n.max())} frames, "
        f"{len(res.clusters)} clusters): K3 launches {launches}, {ckpt} clusters aligned "
        f"through the checkpointed backtrace, 16 distances match the oracle; discover() "
        f"wall {wall:.2f} s; stages {t}")
    log(f"phase 10: K3 at this cell: {k3_s * 1e3:.3f} ms of device time over "
        f"{stats['blocks']} launches (d={f.shape[2]}, {cells:.4g} cells, "
        f"{rate_line(k3_s * 1e3, cells, k3_bound)})")
    return {"launches": launches}


def config4_all_pairs(tag: str, dev, cfg, kernels: tuple, route: str, seed: int,
                      split: dict | None = None, keep: dict | None = None) -> list[int]:
    """All pairs of the config-4 corpus (K=10,240, S=128, d=16, lengths
    64-128) through the scheduler: the route, each kernel's launches (all
    must run, or with ``split``, {entry name: (launches, cells)}, exactly the
    launches it predicts), 64 pairs against the plain torch DTW and 8
    against the oracle, native scatter.  Prints each kernel's device time
    (``kernel_s_by``), and with ``split`` its share of its cells' bound.
    ``keep[route]`` receives (D, stats, wall) for phase 22.  Returns the
    launches."""
    from audio_pattern_discovery_tpu_torch.oracle.dtw import dtw_oracle
    from audio_pattern_discovery_tpu_torch.ops.dtw import dtw_batch
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances

    K, S, d = 10_240, 128, 16
    feats, lens = config4_corpus(K, S, d, seed=4, dev=dev)
    lens_np = lens.cpu().numpy()
    stats: dict = {}
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D = all_pairs_distances(feats, lens_np, cfg, device=dev, stats=stats)
    wall = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    names = ", ".join(f"{k.__name__} {n}" for k, n in zip(kernels, launches))
    n_pairs = K * (K - 1) // 2
    want_launches = ([split.get(k.__name__, (0, 0.0))[0] for k in kernels] if split
                     else [max(n, 1) for n in launches])
    if launches != want_launches or sum(launches) < 1 or stats["route"] != route:
        fail(f"{tag}: the job took route {stats['route']} with launches {names} "
             f"(expected {want_launches})")
    if not stats["native_scatter"]:
        fail(f"{tag}: the scheduler scattered with NumPy: the native library did not load")
    if not np.isfinite(D).all():
        fail(f"{tag}: non-finite distances in D")
    rng = np.random.default_rng(seed)
    ia = rng.integers(0, K, 64)
    ib = (ia + rng.integers(1, K, 64)) % K
    sel_a, sel_b = torch.from_numpy(ia).to(dev), torch.from_numpy(ib).to(dev)
    band = dict(band=cfg.band, band_mode=cfg.band_mode)
    want = dtw_batch(feats[sel_a], feats[sel_b], lens[sel_a], lens[sel_b],
                     normalize="path_len", **band).cpu().numpy()
    if not np.allclose(D[ia, ib], want, rtol=1e-4, atol=1e-5):
        fail(f"{tag}: D disagrees with plain dtw_batch (max abs {np.abs(D[ia, ib] - want).max()})")
    f_np = feats.cpu().numpy()
    for a, b in zip(ia[:8], ib[:8]):
        ref = dtw_oracle(f_np[a, :lens_np[a]], f_np[b, :lens_np[b]], normalize="path_len", **band)
        if not np.isclose(D[a, b], ref, rtol=1e-4, atol=1e-5):
            fail(f"{tag}: D[{a},{b}]={D[a, b]} vs oracle {ref}")
    s = {k: round(v, 3) if isinstance(v, float) else v for k, v in stats.items()}
    mode = "unbanded" if cfg.band is None else f"band {cfg.band}, {cfg.band_mode}"
    kind = {"tile": "full", "diag": "diag", "widen": "widen"}[route]
    cells = job_cells(lens_np, kind, cfg.band)
    bound_ms, _ = bound(cells, d, K * S * d * 4.0 + K * K * 4.0)
    log(f"{tag}: config 4 all-pairs K={K} ({mode}): {n_pairs} pairs in "
        f"{wall:.2f} s = {n_pairs / wall:.0f} pairs/s; kernel device time "
        f"{stats['kernel_s']:.3f} s ({stats['kernel_s'] / wall:.1%} of wall; {cells:.4g} cells, "
        f"{rate_line(stats['kernel_s'] * 1e3, cells, bound_ms)}), scatter "
        f"{stats['scatter_s']:.3f} s, launches {names}; "
        f"64 pairs match plain dtw_batch, 8 match the oracle; stats {s}")
    for k, n in zip(kernels, launches):
        secs = stats["kernel_s_by"].get(k.__name__, 0.0)
        line = f"{tag}: {k.__name__}: {n} launches, {secs:.3f} s of device time"
        if split and n:
            k_cells = split[k.__name__][1]
            k_bound, _ = bound(k_cells, d, 0.0)
            line += f" ({k_cells:.4g} cells, {rate_line(secs * 1e3, k_cells, k_bound)})"
        log(line)
    if keep is not None:
        keep[route] = (D, stats, wall)
    return launches


def phase11(dev, keep: dict) -> dict:
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_pairs

    config4_all_pairs("phase 11", dev, DTWConfig(band=None, normalize="path_len"),
                      (dtw_tile_pairs,), "tile", seed=11, keep=keep)


def shortfall(tag: str, cut, full, over) -> None:
    """A contract shortfall: +inf on exactly the cut pairs (``over``), and the
    other pairs bitwise equal to the call without it."""
    if not (bool(over.any()) and bool((~over).any())):
        fail(f"{tag}: the shortfall cuts no pair or every pair")
    if not (bool(torch.isinf(cut[over]).all()) and bool(torch.equal(cut[~over], full[~over]))):
        fail(f"{tag}: the shortfall did not give +inf on exactly the cut pairs")


def widen_inputs(dev, nT: int, S: int, d: int, lo: int, seed: int):
    """K4/K5 arguments on a length-sorted corpus (ti=128, lengths lo..S,
    band 16) for all its upper tile-pairs, at the class contract."""
    ti, band = 128, 16
    feats, lens = sorted_corpus(ti * nT, S, d, lo, S, seed=seed, dev=dev)
    tmin, tmax = tile_ranges(lens.cpu().numpy(), nT, ti)
    pairs = [(i, j) for i in range(nT) for j in range(i, nT)]
    ii = torch.tensor([p[0] for p in pairs], dtype=torch.int32, device=dev)
    jj = torch.tensor([p[1] for p in pairs], dtype=torch.int32, device=dev)
    kw = dict(ti=ti, band=band, wv_max=max(band, max(tmax) - min(tmin)), rows=max(tmax))
    return (feats, lens, ii, jj), kw


def widen_sweep(tag: str, kernel, rtol: float, atol: float) -> list[int]:
    """The kernel against the twin at every frame width it is built for, at
    both padded lengths of config-4-like jobs (S=128 and 256, lengths S/2..S,
    2 tiles, all 3 tile-pairs); returns the float4s a frame covered."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
        dtw_tile_lane_pairs_ref,
        strip_channels,
    )

    for S_w in (128, 256):
        for dd in (16, *SWEEP_DIMS):
            args, kw = widen_inputs(torch.device("cuda", 0), 2, S_w, dd, S_w // 2, seed=S_w + dd)
            agree(f"{tag} (S={S_w}, d={dd})", kernel(*args, **kw),
                  dtw_tile_lane_pairs_ref(*args, **kw), rtol, atol)
    return sorted({strip_channels(x) for x in (16, *SWEEP_DIMS)})


def phase12(dev) -> dict:
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
        dtw_tile_lane_pairs,
        dtw_tile_lane_pairs_ref,
        strip_layout,
    )

    # The config-4 widen shape: 4 tiles of lengths 64-128, all 10 tile-pairs.
    (feats, lens, ii, jj), kw = widen_inputs(dev, 4, 128, 16, 64, seed=12)
    ti, S, d, band, wv = kw["ti"], 128, 16, kw["band"], kw["wv_max"]
    got = dtw_tile_lane_pairs(feats, lens, ii, jj, **kw)
    torch.cuda.synchronize()
    want = dtw_tile_lane_pairs_ref(feats, lens, ii, jj, **kw)
    if not bool(torch.isfinite(got).all()):
        fail("phase 12: K4 returned non-finite distances inside the class contract")
    max_abs = agree("phase 12 (euclidean)", got, want, K4_RTOL, K4_ATOL)
    # A diagonal and the widest cross tile-pair for the other metrics and a
    # hard band (+inf where the corner is out of the band).
    sub = (ii[[0, 3]], jj[[0, 3]])
    for extra in (dict(metric="sqeuclidean"), dict(metric="cosine"), dict(auto_widen=False)):
        agree(f"phase 12 ({extra})", dtw_tile_lane_pairs(feats, lens, *sub, **kw, **extra),
              dtw_tile_lane_pairs_ref(feats, lens, *sub, **kw, **extra), K4_RTOL, K4_ATOL)
    # rows below half the A tile of (1, 2); wv_max below half the widened
    # half-widths of (0, 3).
    r_cut = int(torch.sort(lens[ti:2 * ti]).values[ti // 2])
    cut = dtw_tile_lane_pairs(feats, lens, ii[[5]], jj[[5]], **{**kw, "rows": r_cut})[0]
    shortfall("phase 12 (rows)", cut, got[5], (lens[ti:2 * ti] > r_cut)[:, None].expand_as(cut))
    diffs = (lens[:ti, None] - lens[None, 3 * ti:]).abs()
    w_cut = max(band, int(diffs.float().median()))
    cut = dtw_tile_lane_pairs(feats, lens, ii[[3]], jj[[3]], **{**kw, "wv_max": w_cut})[0]
    shortfall("phase 12 (wv_max)", cut, got[3], diffs > w_cut)
    widths = widen_sweep("phase 12", dtw_tile_lane_pairs, K4_RTOL, K4_ATOL)
    # Timed as the scheduler launches it: the corpus layout built once.
    frames = strip_layout(feats, ti)
    ms = cuda_ms(lambda: dtw_tile_lane_pairs(feats, lens, ii, jj, frames=frames, **kw), 20)
    plain_ms = cuda_ms(lambda: dtw_tile_lane_pairs_ref(feats, lens, ii, jj, **kw), 1, warm=False)
    n_pairs = len(ii) * ti * ti
    cells = tile_call_cells(lens, ii, jj, ti, "widen", band)
    bound_ms, bound_by = bound(cells, d, tile_call_bytes(ii, jj, ti, S, d))
    log(f"phase 12: K4 vs plain on {len(ii)} tile-pairs ({n_pairs} pairs, S={S}, band {band}, "
        f"wv_max {wv}, W={2 * wv + 2}): max abs err {max_abs:.3g} (rtol {K4_RTOL}, atol "
        f"{K4_ATOL}); sqeuclidean, cosine and a hard band agree; rows and wv_max shortfalls "
        f"+inf on exactly the cut pairs; S=128 and 256 at float4s a frame {widths} agree")
    log(f"phase 12: K4 {ms:.3f} ms/call ({n_pairs / ms * 1e3:.0f} pairs/s, "
        f"{rate_line(ms, cells, bound_ms)}), plain {plain_ms:.3f} ms/call "
        f"({n_pairs / plain_ms * 1e3:.0f} pairs/s)")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase13(dev) -> dict:
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
        dtw_tile_lane_pairs_ref,
        dtw_tile_stripe_pairs,
        frame_layout,
    )

    # A config-4 wide class (its main-path cell): phase 12's tiles, W=130.
    (feats, lens, ii, jj), kw = widen_inputs(dev, 4, 128, 16, 64, seed=12)
    ti, d, band = kw["ti"], 16, kw["band"]
    got = dtw_tile_stripe_pairs(feats, lens, ii, jj, **kw)
    torch.cuda.synchronize()
    want = dtw_tile_lane_pairs_ref(feats, lens, ii, jj, **kw)
    if not bool(torch.isfinite(got).all()):
        fail("phase 13: K5 returned non-finite distances inside the class contract")
    max_abs = agree("phase 13 (config 4)", got, want, K5_RTOL, K5_ATOL)
    sub = (ii[[0, 3]], jj[[0, 3]])
    for extra in (dict(metric="sqeuclidean"), dict(metric="cosine"), dict(auto_widen=False)):
        agree(f"phase 13 ({extra})", dtw_tile_stripe_pairs(feats, lens, *sub, **kw, **extra),
              dtw_tile_lane_pairs_ref(feats, lens, *sub, **kw, **extra), K5_RTOL, K5_ATOL)
    widths = widen_sweep("phase 13", dtw_tile_stripe_pairs, K5_RTOL, K5_ATOL)
    frames = frame_layout(feats)
    ms = cuda_ms(lambda: dtw_tile_stripe_pairs(feats, lens, ii, jj, frames=frames, **kw), 20)
    plain_ms = cuda_ms(lambda: dtw_tile_lane_pairs_ref(feats, lens, ii, jj, **kw), 1, warm=False)
    cells = tile_call_cells(lens, ii, jj, ti, "widen", band)
    bound_ms, bound_by = bound(cells, d, tile_call_bytes(ii, jj, ti, 128, d))
    log(f"phase 13: K5 vs plain at a config-4 wide class ({len(ii)} tile-pairs, S=128, "
        f"W={2 * kw['wv_max'] + 2}): max abs err {max_abs:.3g} (rtol {K5_RTOL}, atol {K5_ATOL}); "
        f"sqeuclidean, cosine and a hard band agree; S=128 and 256 at float4s a frame {widths} "
        f"agree")
    log(f"phase 13: K5 {ms:.3f} ms/call ({rate_line(ms, cells, bound_ms)}), plain "
        f"{plain_ms:.3f} ms/call")

    # Long units: S=1024, lengths 257-1024, 3 tile-pairs, both shortfalls.
    (feats, lens, ii, jj), kw = widen_inputs(dev, 2, 1024, 16, 257, seed=13)
    tmin, tmax = tile_ranges(lens.cpu().numpy(), 2, ti)
    got = dtw_tile_stripe_pairs(feats, lens, ii, jj, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = dtw_tile_lane_pairs_ref(feats, lens, ii, jj, **kw)
    torch.cuda.synchronize()
    long_plain = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(got).all()):
        fail("phase 13: K5 returned non-finite distances inside the class contract (S=1024)")
    long_err = agree("phase 13 (S=1024)", got, want, K5_RTOL, K5_ATOL)
    r_cut = (tmin[0] + tmax[0]) // 2
    cut = dtw_tile_stripe_pairs(feats, lens, ii[[1]], jj[[1]], **{**kw, "rows": r_cut})[0]
    shortfall("phase 13 (rows)", cut, got[1], (lens[:ti] > r_cut)[:, None].expand_as(cut))
    diffs = (lens[:ti, None] - lens[None, ti:]).abs()
    w_cut = max(band, int(diffs.float().median()))
    cut = dtw_tile_stripe_pairs(feats, lens, ii[[1]], jj[[1]], **{**kw, "wv_max": w_cut})[0]
    shortfall("phase 13 (wv_max)", cut, got[1], diffs > w_cut)
    frames = frame_layout(feats)
    long_ms = cuda_ms(lambda: dtw_tile_stripe_pairs(feats, lens, ii, jj, frames=frames, **kw), 3)
    cells = tile_call_cells(lens, ii, jj, ti, "widen", band)
    long_bound, long_by = bound(cells, d, tile_call_bytes(ii, jj, ti, 1024, d))
    log(f"phase 13: K5 vs plain on 3 tile-pairs (S=1024, lengths 257-1024, wv_max "
        f"{kw['wv_max']}): max abs err {long_err:.3g}; rows and wv_max shortfalls +inf on "
        f"exactly the cut pairs; K5 {long_ms:.3f} ms/call ({rate_line(long_ms, cells, long_bound)}), "
        f"plain {long_plain:.3f} ms/call")
    # The kernel line takes the long-units shape: the gate sends K5 only
    # classes wider than LANE_MAX_W, which config 4 never has.
    return {"max_abs_err": max(max_abs, long_err), "ms": long_ms, "plain_ms": long_plain,
            "bound_ms": long_bound, "bound_by": long_by}


def widen_split(lens_np, cfg, ti: int = 128, chunk: int = 64) -> dict:
    """{kernel entry name: (launches, cells)} that the scheduler's widen
    classes and K4/K5 gate give the job of lengths ``lens_np``: the same
    length sort, tile ranges, class merge and chunking, and each tile-pair's
    share of the job's DP cells (``pair_cells``)."""
    from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as ps

    K = len(lens_np)
    Kp, Lp = -(-K // ti) * ti, ps.padded_len(int(lens_np.max()))
    nT = Kp // ti
    lens_p = np.ones(Kp, np.int32)
    lens_p[:K] = np.sort(lens_np, kind="stable")
    pair_class = ps.make_tile_stripe_class_fn(lens_p, nT, ti, Lp, int(cfg.band),
                                              cfg.auto_widen_band, K)
    by_class: dict = {}
    for i in range(nT):
        for j in range(i, nT):
            by_class.setdefault(pair_class(i, j), []).append((i, j))
    ps._merge_thin_classes(by_class)
    vals = np.unique(lens_np)
    idx = {int(v): n for n, v in enumerate(vals)}
    hist = np.zeros((nT, len(vals)))
    for t in range(nT):
        for v in lens_p[t * ti:min((t + 1) * ti, K)]:
            hist[t, idx[int(v)]] += 1
    la = torch.from_numpy(np.repeat(vals, len(vals)).astype(np.int64))
    lb = torch.from_numpy(np.tile(vals, len(vals)).astype(np.int64))
    table = pair_cells(la, lb, "widen", cfg.band).numpy().reshape(len(vals), len(vals))
    out: dict = {}
    for cls, plist in by_class.items():
        name = ps.widen_kernel(cls[1]).__name__
        launches, cells = out.get(name, (0, 0.0))
        launches += -(-len(plist) // chunk)
        for i, j in plist:
            w = np.outer(hist[i], hist[j])
            if i == j:
                w = (w - np.diag(hist[i])) / 2
            cells += float((w * table).sum())
        out[name] = (launches, cells)
    return out


def phase14(dev) -> dict:
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
        dtw_tile_lane_pairs,
        dtw_tile_stripe_pairs,
    )

    cfg = DTWConfig(band=16, band_mode="widen", normalize="path_len")
    lens_np = config4_corpus(10_240, 128, 16, seed=4, dev=dev)[1].cpu().numpy()
    k4, k5 = config4_all_pairs("phase 14", dev, cfg, (dtw_tile_lane_pairs, dtw_tile_stripe_pairs),
                               "widen", seed=14, split=widen_split(lens_np, cfg))
    return {"launches": k4, "k5_launches": k5}


def phase15(dev, tmp: Path) -> dict:
    from audio_pattern_discovery_tpu_torch.config import PipelineConfig
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_stripe_pairs
    from audio_pattern_discovery_tpu_torch.pipeline import discover

    cfg = PipelineConfig().override({
        "segmentation.max_len_frames": 1024, "dtw.max_seq_len": 1024, "dtw.band": 16,
        "dtw.band_mode": "widen", "autoencoder.method": "pca", "output.write_images": False,
        "output.write_alignments": False,
    })
    dtw_tile_stripe_pairs.launches = 0
    t0 = time.perf_counter()
    res = discover(long_units_corpus(tmp), cfg, out_dir=tmp / "long_units_widen_out", device=dev)
    wall = time.perf_counter() - t0
    launches = dtw_tile_stripe_pairs.launches
    if launches < 1:
        fail("phase 15: the long-unit widen job never launched K5")
    D, f, n = res.distance_matrix, res.seg_features, res.seg_lengths
    if not np.isfinite(D).all() or len(res.clusters) < 1:
        fail("phase 15: non-finite distances or no clusters")
    rng = np.random.default_rng(15)
    ia = rng.integers(0, len(n), 8)
    ib = (ia + rng.integers(1, len(n), 8)) % len(n)
    for a, b, want in zip(ia, ib, oracle_pairs(f, n, ia, ib, band=16, band_mode="widen")):
        if not np.isclose(D[a, b], want, rtol=K5_RTOL, atol=1e-5):
            fail(f"phase 15: D[{a},{b}]={D[a, b]} vs oracle {want}")
    t = {k: round(v, 3) for k, v in res.counters.timings_s.items()}
    log(f"phase 15: long units widen ({len(n)} segments of {int(n.min())}-{int(n.max())} frames, "
        f"{len(res.clusters)} clusters): K5 launches {launches}, 8 distances match the oracle; "
        f"discover() wall {wall:.2f} s (alignments off); stages {t}")
    return {"launches": launches}


def gathered_pairs(dev, B: int, S: int, d: int, wv: int, diff_lo: int, seed: int,
                   lb_lo: int | None = None, route_order: bool = False):
    """K6's and K7's arguments for B gathered pairs of one per-pair class:
    lb in [lb_lo, S] (the top 124 frames of S by default), la = lb - diff
    with diff in [diff_lo, wv] (the scheduler's class of pairs with
    max_len_diff wv, shorter side first); with ``route_order`` the pairs
    sorted by (la, lb), as the per-pair route orders a block."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lo = S - 123 if lb_lo is None else lb_lo
    lb = torch.randint(lo, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    la = lb - torch.randint(diff_lo, wv + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    if route_order:
        order = torch.argsort(la.long() * (S + 1) + lb)
        la, lb = la[order].contiguous(), lb[order].contiguous()
    return (torch.randn((B, S, d), generator=g, device=dev),
            torch.randn((B, S, d), generator=g, device=dev), la, lb)


def route_pairs(lens, n: int, seed: int):
    """n random pairs (ia, ib) of a corpus with lengths ``lens``, shorter side
    first, in the per-pair route's order (``enumerate_pair_blocks``: the
    pairs of one shorter sequence together, their longer sides by length)."""
    K, top = lens.shape[0], int(lens.max()) + 1
    g = torch.Generator(device=lens.device).manual_seed(seed)
    ia = torch.randint(0, K, (n,), generator=g, device=lens.device)
    ib = torch.randint(0, K, (n,), generator=g, device=lens.device)
    swap = lens[ia] > lens[ib]
    ia, ib = torch.where(swap, ib, ia), torch.where(swap, ia, ib)
    order = torch.argsort((lens[ia].long() * K + ia) * top + lens[ib].long())
    return ia[order], ib[order]


# K7's sweep in phase 16: the per-pair route's first two band-16 classes
# (max_len_diff 63 at S=512, 127 at S=1024: diffs 0-63 and 64-127).
K7_CLASSES = ((63, 512, 0), (127, 1024, 64))


def k7_sweep(dev) -> list:
    """K7 against its twin on 64 gathered pairs of each class in K7_CLASSES
    at every frame width it is built for (d=16, 4, 8, 20, 40), with the other
    two metrics at d=16, and a hard band 16 over class 63's pairs (+inf
    where the corner is outside the band); returns (float4s a frame,
    metric, class half-width) covered."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
        _dtw_batch_stripe,
        _dtw_batch_stripe_ref,
        strip_channels,
    )

    done = []
    for wv, S, diff_lo in K7_CLASSES:
        cases = [(16, dict(metric=m)) for m in ("euclidean", "sqeuclidean", "cosine")]
        cases += [(x, dict(metric="euclidean")) for x in SWEEP_DIMS]
        if wv == 63:
            cases.append((16, dict(metric="euclidean", auto_widen=False)))
        for dd, extra in cases:
            args = gathered_pairs(dev, 64, S, dd, wv, diff_lo, seed=wv + dd)
            kw = dict(band=16, max_len_diff=wv, **extra)
            got = _dtw_batch_stripe(*args, **kw)
            if extra.get("auto_widen", True) and not bool(torch.isfinite(got).all()):
                fail(f"phase 16: K7 returned non-finite distances in class {wv} ({dd}, {extra})")
            agree(f"phase 16 (K7 class {wv}, d={dd}, {extra})", got,
                  _dtw_batch_stripe_ref(*args, **kw), K7_RTOL, K7_ATOL)
            w = wv if extra.get("auto_widen", True) else 16
            done.append((strip_channels(dd), extra["metric"], w))
    return done


def sqrt_check(dev, name: str, fn, S: int) -> str:
    """A systolic kernel's Euclidean cost bit for bit against the IEEE square
    root of its squared cost (csrc/dtw_systolic.cuh:sqrt_rn against sqrtf's
    rounding): single-cell pairs (``fn(a, b, la, lb, metric=...)`` on
    [B, S, 4] operands) whose two nonzero channels give sums of squares of 0,
    denormals, values around 2^-101 (sqrt_rn's rescaling edge), every power
    of two and its double, random bit patterns and +inf on overflow."""
    rng = np.random.default_rng(161)
    pw2 = np.exp2(np.arange(-160, 141) / 2).astype(np.float32)
    edge = (2.0 ** -50.5 * (1 + np.arange(-2048, 2048) * 2.0 ** -12)).astype(np.float32)
    den = np.exp2(rng.uniform(-76, -62, 4096)).astype(np.float32)
    bits = rng.integers(0, 0x5F800000, (2, 16384), dtype=np.uint32).view(np.float32)
    v0 = np.concatenate([[0.0], pw2, pw2, edge, den, den, bits[0]])
    v1 = np.concatenate([[0.0], 0 * pw2, pw2, 0 * edge, 0 * den, den[::-1], bits[1]])
    B = len(v0)
    a = torch.zeros((B, S, 4), device=dev)
    a[:, 0, :2] = torch.from_numpy(np.stack([v0, v1], 1).astype(np.float32)).to(dev)
    b = torch.zeros_like(a)
    one = torch.ones(B, dtype=torch.int32, device=dev)
    got = fn(a, b, one, one, metric="euclidean").cpu().numpy()
    acc = fn(a, b, one, one, metric="sqeuclidean").cpu().numpy()
    want = np.sqrt(acc.astype(np.float64)).astype(np.float32)
    bad = got.view(np.uint32) != want.view(np.uint32)
    if bad.any():
        n = int(np.argmax(bad))
        fail(f"phase 16: {name}'s sqrt differs from the IEEE sqrt on {int(bad.sum())} of {B} "
             f"costs (first: sqrt({acc[n]!r}) = {got[n]!r}, want {want[n]!r})")
    tiny = (acc > 0) & (acc < 2.0 ** -101)
    if not tiny.any():
        fail("phase 16: the sqrt check reached no cost below 2^-101")
    return (f"{name}'s sqrt bitwise the IEEE sqrt on {B} costs ({int((acc == 0).sum())} zero, "
            f"{int(((acc > 0) & (acc < 2.0 ** -126)).sum())} denormal, {int(tiny.sum())} in "
            f"(0, 2^-101), {int(np.isinf(acc).sum())} +inf)")


# K6's sweep in phase 16: (S, pairs, lb_lo) and per mode (band keywords,
# diffs la - lb), each padded length where dtw_cuda._rowscan_geometry
# changes its lane group.  The hard band is 16 where K6 takes it (S <= 256);
# at S=1024 the route sends bands up to 127 to K7, so K6's narrowest hard
# band there is 128.  Widen at S=1024 is the class only K6 takes (diffs
# > 127).
K6_SWEEP = (
    (128, 64, 64, (("unbanded", dict(band=None), 0, 63), ("widen 16", dict(band=16), 0, 63),
                   ("hard 16", dict(band=16, auto_widen=False), 0, 63))),
    (256, 32, 128, (("unbanded", dict(band=None), 0, 127), ("widen 16", dict(band=16), 0, 127),
                    ("hard 16", dict(band=16, auto_widen=False), 0, 31))),
    (1024, 32, None, (("unbanded", dict(band=None), 0, 123),
                      ("widen 16", dict(band=16), 128, 255),
                      ("hard 128", dict(band=128, auto_widen=False), 64, 191))),
)


def k6_sweep(dev) -> list:
    """K6 against its twin on gathered pairs of each K6_SWEEP class at every
    frame width it is built for (d=16, 4, 8, 20, 40) and, at d=16, every
    metric; +inf on exactly the pairs whose corner is outside a hard band,
    and on exactly the cut pairs of a rows shortfall (la > R).  Returns the
    (S, mode) covered."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_batch_pallas, dtw_batch_pallas_ref

    done = []
    cases = [(16, m) for m in ("euclidean", "sqeuclidean", "cosine")]
    cases += [(x, "euclidean") for x in SWEEP_DIMS]
    for S, B, lb_lo, modes in K6_SWEEP:
        for mode, kw, lo, hi in modes:
            for dd, metric in cases:
                args = gathered_pairs(dev, B, S, dd, hi, lo, seed=S + dd + hi, lb_lo=lb_lo)
                n0 = dtw_batch_pallas.launches
                got = dtw_batch_pallas(*args, metric=metric, **kw)
                if dtw_batch_pallas.launches != n0 + 1:
                    fail(f"phase 16: K6's sweep class S={S} {mode} did not launch K6")
                over = (args[2] - args[3]).abs() > kw["band"] if "auto_widen" in kw else None
                tag = f"phase 16 (K6 S={S} {mode}, d={dd}, {metric})"
                if over is None and not bool(torch.isfinite(got).all()):
                    fail(f"{tag}: non-finite distances")
                if over is not None and not (bool(over.any()) and bool((~over).any()) and bool(
                        torch.isinf(got[over]).all()) and bool(torch.isfinite(got[~over]).all())):
                    fail(f"{tag}: +inf not on exactly the pairs outside the hard band")
                agree(tag, got, dtw_batch_pallas_ref(*args, metric=metric, **kw), K6_RTOL, K6_ATOL)
            done.append((S, mode))
    a, b, la, lb = gathered_pairs(dev, 64, 128, 16, 63, 0, seed=1616, lb_lo=64)
    r_cut = int(la.median())
    shortfall("phase 16 (K6 rows)", dtw_batch_pallas(a[:, :r_cut], b, la, lb, band=16),
              dtw_batch_pallas(a, b, la, lb, band=16), la > r_cut)
    return done


def k6_times(dev, feats, lens) -> dict:
    """K6 where the per-pair route runs it, by ``cuda_ms``: 131,072 pairs
    (``pair_batch``, the route's launch size at S=128) of the config-4
    corpus in the route's order, widen band 16 and unbanded, each timed
    twice; 2,048 and 8,192 pairs at S=1024 (lb in the top 124 frames, in
    the route's order) unbanded (diffs 0-123) and widen band 16 in the class
    only K6 takes (diffs 128-255).  Logs each with its bound (the gathered
    pairs' live bytes, or the cells' fp32 operations); returns {case: median
    ms}."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_batch_pallas

    ia, ib = route_pairs(lens, 131_072, seed=161)
    cases = [(f"131072 pairs, S=128, {m}", lambda: (feats[ia], feats[ib], lens[ia], lens[ib]),
              band, 2) for m, band in (("widen band 16", 16), ("unbanded", None))]
    for B in (2048, 8192):
        for m, band, lo, hi in (("unbanded", None, 0, 123), ("widen band 16, diffs 128-255", 16,
                                                            128, 255)):
            cases.append((f"{B} pairs, S=1024, {m}", partial(
                gathered_pairs, dev, B, 1024, 16, hi, lo, seed=B + lo, route_order=True), band, 1))
    res = {}
    for tag, make, band, n_runs in cases:
        args = make()
        S = args[1].shape[1]
        runs = [[] for _ in range(n_runs)]
        for r in runs:
            cuda_ms(partial(dtw_batch_pallas, *args, band=band), 20 if S == 128 else 10, per_call=r)
        cells = float(pair_cells(args[2], args[3], "full" if band is None else "widen", band).sum())
        bound_ms, by = bound(cells, 16, pair_bytes(args[2], args[3], 16))
        med = sorted(runs[0])[len(runs[0]) // 2]
        log(f"phase 16: K6 at {tag}: " + "; ".join(f"run {n + 1} {spread(r)}"
                                                   for n, r in enumerate(runs))
            + f"; bound {bound_ms:.4f} ms ({by}, {cells:.4g} cells), {bound_ms / med:.1%} of it")
        res[tag] = med
        del args
    return res


def per_pair_jobs(dev, feats, lens) -> tuple[int, int]:
    """The per-pair route ``all_pairs_distances(tiled=False)``, widen band 16
    and unbanded, on a K=2,048 slice of the config-4 corpus and on 256
    sequences of 900-1024 frames, each job three times: D must equal the
    tiled D (widen: K4 or K5; unbanded: K2 at S=128, K3 at S=1024).  Prints
    each job's walls (they move with the host's load) and the split of its
    median run: K6's and K7's device time, the gathers', and the host's
    enumerate, dispatch, collect (waiting for values) and scatter.  K6 must
    launch in the unbanded long job and K7 in the widen one.  Returns the
    launches of K6 and K7 in all runs."""
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import _dtw_batch_stripe, dtw_batch_pallas
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances

    long_feats, long_lens = sorted_corpus(256, 1024, 16, 900, 1024, seed=16, dev=dev)
    dtw_batch_pallas.launches = _dtw_batch_stripe.launches = 0
    for name, f, n in (("config-4 slice K=2048", feats[:2048], lens[:2048]),
                       ("lengths 900-1024 K=256", long_feats, long_lens)):
        n_np = n.cpu().numpy()
        for band in (16, None):
            cfg = DTWConfig(band=band, band_mode="widen", normalize="path_len")
            mode = "unbanded" if band is None else "widen band 16"
            tiled = all_pairs_distances(f, n_np, cfg, device=dev)
            runs = []
            for _ in range(3):
                before = (dtw_batch_pallas.launches, _dtw_batch_stripe.launches)
                stats: dict = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                D = all_pairs_distances(f, n_np, cfg, device=dev, tiled=False, stats=stats)
                wall = time.perf_counter() - t0
                k6_n = dtw_batch_pallas.launches - before[0]
                k7_n = _dtw_batch_stripe.launches - before[1]
                if not np.isfinite(D).all() or not np.allclose(D, tiled, rtol=1e-4, atol=1e-5):
                    fail(f"phase 16: per-pair D ({name}, {mode}) differs from the tiled D (max "
                         f"abs {np.abs(D - tiled).max()})")
                if f is long_feats and (k6_n if band is None else k7_n) < 1:
                    fail(f"phase 16: the per-pair {mode} job at 900-1024 frames launched K6 "
                         f"{k6_n} and K7 {k7_n} times")
                runs.append((wall, stats))
            walls = [w for w, _ in runs]
            wall, stats = sorted(runs, key=lambda r: r[0])[1]
            by = stats["kernel_s_by"]
            pairs = stats["pairs"]
            log(f"phase 16: per-pair route, {name}, {mode}: {pairs} pairs, walls "
                f"{' / '.join(f'{w:.3f}' for w in walls)} s; median {wall:.3f} s = "
                f"{pairs / wall:.0f} pairs/s, {stats['blocks']} blocks ({k6_n} K6, {k7_n} K7 "
                f"launches); device: K6 {by.get('dtw_batch_pallas', 0.0):.4f} s + K7 "
                f"{by.get('_dtw_batch_stripe', 0.0):.4f} s + gathers {stats['gather_s']:.4f} s; "
                f"host: dispatch {stats['dispatch_s']:.4f} s, collect {stats['collect_s']:.4f} s, "
                f"scatter {stats['scatter_s']:.4f} s, enumerate {stats['enumerate_s']:.4f} s; "
                f"D equals the tiled D")
    return dtw_batch_pallas.launches, _dtw_batch_stripe.launches


def k6_pairs(lens, g):
    """Phase 16's 4,096 K6 pairs (ia, ib) among the first 2,048 sequences,
    drawn from the generator g, shorter side first."""
    ia = torch.randint(0, 2048, (4096,), generator=g, device=lens.device)
    ib = torch.randint(0, 2048, (4096,), generator=g, device=lens.device)
    swap = lens[ia] > lens[ib]
    return torch.where(swap, ib, ia), torch.where(swap, ia, ib)


def phase16(dev) -> dict:
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
        _dtw_batch_stripe,
        _dtw_batch_stripe_ref,
        dtw_batch_pallas,
        dtw_batch_pallas_ref,
    )

    # K6 at the config-4 shape: 4096 gathered pairs, shorter side first.
    feats, lens = config4_corpus(10_240, 128, 16, seed=4, dev=dev)
    g = torch.Generator(device=dev).manual_seed(16)
    ia, ib = k6_pairs(lens, g)
    args6 = (feats[ia], feats[ib], lens[ia], lens[ib])
    k6 = {}
    for tag, kw in (("widen", dict(band=16)), ("unbanded", dict(band=None))):
        got = dtw_batch_pallas(*args6, **kw)
        torch.cuda.synchronize()
        err = agree(f"phase 16 (K6 {tag})", got, dtw_batch_pallas_ref(*args6, **kw),
                    K6_RTOL, K6_ATOL)
        k6.setdefault("max_abs_err", err)
    k6_variants = k6_sweep(dev)
    k6_sqrt = sqrt_check(dev, "K6", partial(dtw_batch_pallas, band=None), 8)
    k6_device: list[float] = []
    cuda_ms(lambda: dtw_batch_pallas(*args6, band=16), 20, per_call=k6_device)
    k6["ms"] = sorted(k6_device)[len(k6_device) // 2]
    k6["plain_ms"] = cuda_ms(lambda: dtw_batch_pallas_ref(*args6, band=16), 1, warm=False)
    k6["bound_ms"], k6["bound_by"] = bound(
        float(pair_cells(args6[2], args6[3], "widen", 16).sum()), 16,
        pair_bytes(args6[2], args6[3], 16))
    # K7 at a long bucket: 512 gathered pairs of 900-1024 frames, S=1024,
    # in the max_len_diff class 63 (a 128-slot stripe on the reference).
    B, S, d = 512, 1024, 16
    la = torch.randint(900, 961, (B,), generator=g, device=dev, dtype=torch.int32)
    lb = la + torch.randint(0, 64, (B,), generator=g, device=dev, dtype=torch.int32)
    a = torch.randn((B, S, d), generator=g, device=dev)
    b = torch.randn((B, S, d), generator=g, device=dev)
    args7 = (a, b, la, lb)
    got7 = _dtw_batch_stripe(*args7, band=16, max_len_diff=63)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want7 = _dtw_batch_stripe_ref(*args7, band=16, max_len_diff=63)
    torch.cuda.synchronize()
    k7 = {"plain_ms": (time.perf_counter() - t0) * 1e3}
    k7["max_abs_err"] = agree("phase 16 (K7)", got7, want7, K7_RTOL, K7_ATOL)
    shortfall("phase 16 (K7 max_len_diff)", _dtw_batch_stripe(*args7, band=16, max_len_diff=31),
              got7, (la - lb).abs() > 31)
    k7_variants = k7_sweep(dev)
    k7_sqrt = sqrt_check(dev, "K7", partial(_dtw_batch_stripe, band=16, max_len_diff=0), 512)
    k7["ms"] = cuda_ms(lambda: _dtw_batch_stripe(*args7, band=16, max_len_diff=63), 5)
    k7["bound_ms"], k7["bound_by"] = bound(float(pair_cells(la, lb, "widen", 16).sum()), d,
                                           pair_bytes(la, lb, d))
    # At a launch size of the per-pair job below: the scheduler pads each
    # block to a power of two, and its 11 K7 launches (32,640 pairs) are
    # 2,048-8,192 pairs, 4,096 the median; the same length distribution.
    B_job = 4096
    la_j = torch.randint(900, 961, (B_job,), generator=g, device=dev, dtype=torch.int32)
    lb_j = la_j + torch.randint(0, 64, (B_job,), generator=g, device=dev, dtype=torch.int32)
    args_j = (torch.randn((B_job, S, d), generator=g, device=dev),
              torch.randn((B_job, S, d), generator=g, device=dev), la_j, lb_j)
    job_ms = cuda_ms(lambda: _dtw_batch_stripe(*args_j, band=16, max_len_diff=63), 3)
    job_bound, _ = bound(float(pair_cells(la_j, lb_j, "widen", 16).sum()), d,
                         pair_bytes(la_j, lb_j, d))
    del args_j, args7, a, b
    log(f"phase 16: K6 vs plain on 4096 gathered pairs (S=128, widen band 16 and unbanded): max "
        f"abs err {k6['max_abs_err']:.3g} (rtol {K6_RTOL}, atol {K6_ATOL}); K6 "
        f"{spread(k6_device)} (bound {k6['bound_ms']:.4f} ms, {k6['bound_ms'] / k6['ms']:.1%} of "
        f"it); plain {k6['plain_ms']:.3f} ms/call")
    log(f"phase 16: K6 vs plain at (S, mode) {k6_variants}, each at d=16, 4, 8, 20, 40 and the "
        f"three metrics, agree; +inf on exactly the pairs outside the hard bands and the cut "
        f"pairs of a rows shortfall; {k6_sqrt}")
    log(f"phase 16: K7 vs plain on {B} gathered pairs (S={S}, band 16, max_len_diff 63): max abs "
        f"err {k7['max_abs_err']:.3g} (rtol {K7_RTOL}, atol {K7_ATOL}); max_len_diff shortfall "
        f"+inf on exactly the cut pairs; K7 {k7['ms']:.3f} ms/call (bound "
        f"{k7['bound_ms']:.4f} ms, {k7['bound_ms'] / k7['ms']:.1%} of it), plain "
        f"{k7['plain_ms']:.3f} ms/call; at {B_job} pairs (a launch of the long per-pair job) "
        f"{job_ms:.3f} ms/call (bound {job_bound:.4f} ms, {job_bound / job_ms:.1%} of it)")
    log(f"phase 16: K7 vs plain on 64 pairs each at (float4s a frame, metric, class "
        f"half-width) {k7_variants} agree; {k7_sqrt}")
    k6_times(dev, feats, lens)
    k6["launches"], k7["launches"] = per_pair_jobs(dev, feats, lens)
    return {"k6": k6, "k7": k7}


def phase17(tmp: Path) -> dict:
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    corpus = tmp / "lenvar"
    make_corpus(corpus, n_clips=10, n_motifs=3, motif_seconds=(0.15, 0.6), seed=11)
    runs = {}
    for where, device in (("card", "cuda"), ("cpu", "cpu")):
        out = tmp / f"lenvar_widen_{where}"
        summary, wall, manifest = cli(f"phase 17 ({where})", corpus, out, "--device", device,
                                      "-s", "dtw.band=16", "-s", "dtw.band_mode=widen",
                                      "-s", "autoencoder.method=pca")
        runs[where] = (summary, np.load(out / "distance_matrix.npy"),
                       sorted(tuple(sorted(m["segment"] for m in c["members"]))
                              for c in manifest["clusters"]), wall)
    (s_gpu, D, part, wall), (s_cpu, D_cpu, part_cpu, wall_cpu) = runs["card"], runs["cpu"]
    launches = sum(int(s_gpu["counts"].get(f"launches.{name}", 0))
                   for name in ("dtw_tile_lane_pairs", "dtw_tile_stripe_pairs"))
    if launches < 1 or s_cpu["counts"].get("dtw_kernel_launches", 0) != 0:
        fail(f"phase 17: K4/K5 launches on the card {launches}, kernel launches on the CPU "
             f"{s_cpu['counts'].get('dtw_kernel_launches')}")
    if D.shape != D_cpu.shape or not np.allclose(D, D_cpu, rtol=1e-4, atol=1e-5):
        fail(f"phase 17: the card's D differs from the CPU's (max abs {np.abs(D - D_cpu).max()})")
    if part != part_cpu:
        fail("phase 17: the card's cluster partition differs from the CPU's")
    log(f"phase 17: CLI widen on the length-varied corpus ({s_gpu['n_segments']} segments, "
        f"{len(part)} clusters): card {wall:.2f} s with {launches} K4/K5 launches, CPU "
        f"{wall_cpu:.2f} s; D max abs err {np.abs(D - D_cpu).max():.3g}, partition equal")
    return {"launches": launches}


# Phase 18: the AE (the default embedder) trained on the card and on the
# CPU from the same initial bits.  fp32 runs with TF32 off.  The AE has no
# hand-written kernel (the reference computes it with XLA matmuls and
# optax): its layers are cuBLAS and torch's Adam on the card.
AE_POOL_FRAMES, AE_BINS = 65_536, 513
# Encoding one pool with the same parameters: fp32 products of <= 513 terms
# summed in another order (cuBLAS vs the CPU's BLAS), so within ~1e-6 of
# the latents' scale; bf16 rounds each layer's product and activation to
# 2^-8 relative, as tests/test_torch_autoencoder.py's bf16 tolerance.
AE_ENC_RTOL, AE_ENC_ATOL = 1e-5, 1e-5
AE_ENC_BF16_RTOL, AE_ENC_BF16_ATOL = 2e-2, 2e-2
# Trained on each device from the same initial bits (1,280 steps): every
# epoch's loss to rtol 1e-3, the latents of the pool to 0.1 of their largest
# magnitude and the parameters to 0.5 of the largest parameter magnitude.
# Adam turns a few ulps of a gradient element near 0 into an update of up to
# lr, so two reduction orders drift apart step by step (the JAX package's
# own 1- and 8-device runs differ the same way); measured in fp32 on an
# H100 80GB HBM3 at 700 W: losses 3.6e-4 apart, latents 0.036, parameters
# 0.11 (one bias leaf 0.305 off its own largest magnitude).  bf16 (2
# epochs, to bound the CPU's bf16 time) the same, the losses to rtol 2e-2.
AE_LOSS_RTOL, AE_BF16_LOSS_RTOL = 1e-3, 2e-2
AE_LATENT_REL, AE_PARAM_REL = 0.1, 0.5
# The default config's D on the card against the CPU (phase 20): the AE's
# 20 epochs amplify the devices' reduction orders as above; the CPU's run
# misses the JAX golden by 0.097 in D, the JAX package's own 1-device run by
# 0.079 (tests/test_torch_pipeline.py holds the golden to 0.3).
AE_D_ATOL = 0.3


def ae_pool(seed: int) -> np.ndarray:
    """A seeded pool of [65,536, 513] standardized-scale frames: rank-32
    structure plus noise, so the loss falls."""
    rng = np.random.default_rng(seed)
    basis = rng.standard_normal((32, AE_BINS), dtype=np.float32) / np.float32(np.sqrt(32))
    x = rng.standard_normal((AE_POOL_FRAMES, 32), dtype=np.float32) @ basis
    return x + np.float32(0.3) * rng.standard_normal(x.shape, dtype=np.float32)


def param_rel(got: dict, want: dict) -> float:
    """Largest |got - want| over all parameters, over the largest |want|."""
    diff = max(float((got[k].cpu() - want[k].cpu()).abs().max()) for k in want)
    return diff / max(float(want[k].abs().max()) for k in want)


def ae_device_split(tae, cfg, pool, dev) -> str:
    """One more training call (64 steps) under torch.profiler: the device's
    kernel time and its copies (the pool's upload) against the wall, and
    kernels a step.  Annotation ranges (``Optimizer.step#Adam.step``) are
    not device work and are left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tae.train_autoencoder(pool, cfg, device=dev)
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    if not dev_events:
        return "device time not measured (the profiler saw no device events)"
    copies = [e for e in dev_events if e.name.startswith("Memcpy")]
    kernels = [e for e in dev_events if not e.name.startswith(("Memcpy", "Memset"))]
    copy_s = sum(e.time_range.elapsed_us() for e in copies) * 1e-6
    kern_s = sum(e.time_range.elapsed_us() for e in kernels) * 1e-6
    steps = AE_POOL_FRAMES // cfg.batch_size * cfg.epochs
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    return (f"profiled call ({steps} steps): wall {wall:.3f} s ({wall / steps * 1e3:.2f} ms a "
            f"step), kernels {kern_s:.4f} s ({kern_s / wall:.1%} of the wall; "
            f"{len(kernels) / steps:.1f} a step, {kern_s / steps * 1e6:.1f} us a step), copies "
            f"{copy_s:.4f} s ({len(copies)}, the pool's upload among them); idle "
            f"{1 - (kern_s + copy_s) / wall:.1%}; most kernel time: "
            + "; ".join(f"{name[:60]} {len(t) / steps:.1f}/step {sum(t) / steps:.1f} us/step"
                        for name, t in top))


def phase18(dev, tmp: Path) -> dict:
    from audio_pattern_discovery_tpu_torch.config import AutoencoderConfig
    from audio_pattern_discovery_tpu_torch.models import autoencoder as tae
    from audio_pattern_discovery_tpu_torch.utils import checkpoint as ckpt

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("phase 18: a TF32 flag is on")
    pool = ae_pool(18)
    pool_dev = torch.from_numpy(pool).to(dev)
    bad = []
    for dtype, epochs in (("float32", 20), ("bfloat16", 2)):
        cfg = AutoencoderConfig(dtype=dtype, epochs=epochs, denoising_std=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, losses = tae.train_autoencoder(pool, cfg, device=dev)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        model_c, state_c, losses_c = tae.train_autoencoder(pool, cfg, device="cpu")
        wall_c = time.perf_counter() - t0
        steps = state.step
        z = tae.encode_frames(model, state.params, pool_dev)
        z_c = tae.encode_frames(model_c, state_c.params, pool)
        # The CPU's parameters encoded on the card: the same bits through
        # both devices' layers.
        z_same = tae.encode_frames(model_c, {k: v.to(dev) for k, v in state_c.params.items()},
                                   pool_dev).cpu()
        enc_err = float((z_same - z_c).abs().max())
        loss_rel = np.abs(np.array(losses) - losses_c) / np.abs(losses_c)
        p_rel = param_rel(state.params, state_c.params)
        z_rel = float((z.cpu() - z_c).abs().max() / z_c.abs().max())
        fp32 = dtype == "float32"
        enc_rtol, enc_atol = ((AE_ENC_RTOL, AE_ENC_ATOL) if fp32
                              else (AE_ENC_BF16_RTOL, AE_ENC_BF16_ATOL))
        loss_rtol = AE_LOSS_RTOL if fp32 else AE_BF16_LOSS_RTOL
        if not torch.allclose(z_same, z_c, rtol=enc_rtol, atol=enc_atol):
            bad.append(f"{dtype} encode of the same parameters: max abs err {enc_err}")
        if loss_rel.max() > loss_rtol or p_rel > AE_PARAM_REL or z_rel > AE_LATENT_REL:
            bad.append(f"{dtype} trained: loss rel {loss_rel.max():.3g}, params {p_rel:.3g}, "
                       f"latents {z_rel:.3g}")
        if not losses[-1] < losses[0]:
            bad.append(f"{dtype}: the loss did not fall ({losses[0]} -> {losses[-1]})")
        n_params = sum(t.numel() for t in state.params.values())
        frames = steps * cfg.batch_size
        log(f"phase 18: AE {dtype}, {epochs} epochs on {AE_POOL_FRAMES} x {AE_BINS} frames "
            f"(batch {cfg.batch_size}, {steps} steps, {n_params} parameters): card {wall:.3f} s "
            f"({steps / wall:.1f} steps/s), CPU {wall_c:.3f} s; loss {losses[0]:.5f} -> "
            f"{losses[-1]:.5f} (card) vs {losses_c[-1]:.5f} (CPU): loss rel err first epoch "
            f"{loss_rel[0]:.3g}, max {loss_rel.max():.3g} (rtol {loss_rtol}); params "
            f"{p_rel:.3g} (<= {AE_PARAM_REL}), latents {z_rel:.3g} (<= {AE_LATENT_REL}) of "
            f"their largest magnitude; the same parameters encoded on both: max abs err "
            f"{enc_err:.3g} (rtol {enc_rtol}, atol {enc_atol})")
        if fp32:
            bound_s = 6.0 * n_params * frames / FP32_OPS_S
            log(f"phase 18: fp32 train bound {bound_s * 1e3:.3f} ms (6 x {n_params} parameters x "
                f"{frames} frames over 67 TFLOP/s): {bound_s / wall:.2%} of it")
            enc_ms = cuda_ms(lambda: tae.encode_frames(model, state.params, pool_dev), 10)
            enc_ops = 2.0 * AE_POOL_FRAMES * sum(
                t.numel() for k, t in state.params.items() if k.startswith("enc"))
            enc_bound = max(enc_ops / FP32_OPS_S, (pool.nbytes + z.numel() * 4) / HBM_BYTES_S)
            log(f"phase 18: encode_frames on the pool {enc_ms:.3f} ms (cuda_ms), bound "
                f"{enc_bound * 1e3:.3f} ms ({enc_bound * 1e3 / enc_ms:.1%})")
            log(f"phase 18: {ae_device_split(tae, AutoencoderConfig(epochs=1), pool, dev)}")
            # Checkpoint on the card: the restored encoder gives the same bits.
            scaler = tae.FeatureScaler.fit(pool)
            ckpt.save_ae_checkpoint(tmp / "ae_ckpt18", state, scaler)
            model_r, state_r, scaler_r = ckpt.restore_ae_checkpoint(
                tmp / "ae_ckpt18", cfg, AE_BINS, device=dev)
            if not torch.equal(tae.encode_frames(model_r, state_r.params, pool_dev), z):
                bad.append("the restored checkpoint's encode_frames differs from the saved state's")
            if state_r.step != state.step or not np.array_equal(scaler_r.mean, scaler.mean):
                bad.append("the restored checkpoint's step or scaler differs")
    if bad:
        fail("phase 18: " + "; ".join(bad))
    return {}


def manifest_purity(manifest: dict, truth: list[dict]) -> float:
    """Planted-truth purity of a clusters.json (tests/test_pipeline_e2e.py's
    rule): each member takes the motif whose occurrence its samples overlap
    most; the share of members agreeing with their cluster's majority."""
    agree = total = 0
    for c in manifest["clusters"]:
        motifs = []
        for m in c["members"]:
            clip = int(Path(m["file"]).stem.split("_")[-1])
            best, best_ov = None, 0
            for o in truth:
                ov = min(m["end_sample"], o["start"] + o["length"]) - max(m["start_sample"],
                                                                          o["start"])
                if o["clip"] == clip and ov > best_ov:
                    best, best_ov = o["motif"], ov
            if best is not None:
                motifs.append(best)
        if motifs:
            majority = max(set(motifs), key=motifs.count)
            agree += sum(x == majority for x in motifs)
            total += len(motifs)
    return agree / max(total, 1)


def phase19(tmp: Path) -> dict:
    corpus, truth = config2_corpus(tmp)
    summary, wall, manifest = cli("phase 19", corpus, tmp / "config2_default_out")
    launches = int(summary["counts"].get("launches.dtw_tile_pairs", 0))
    losses = manifest["ae_losses"]
    if launches < 1:
        fail("phase 19: the CLI at the default config never launched K2")
    if manifest["n_clusters"] < 1:
        fail("phase 19: no clusters found")
    if not (losses and losses[-1] < losses[0]):
        fail(f"phase 19: the AE's loss did not fall: {losses}")
    t = {k: round(v, 3) for k, v in summary["timings_s"].items()}
    # torch.optim's first use imports torch._dynamo (its decorators): time
    # that import alone in a fresh process, beside autoencoder_train.
    probe = subprocess.run([sys.executable, "-c", "import time, torch; t0 = time.perf_counter(); "
                            "import torch._dynamo; print(time.perf_counter() - t0)"],
                           capture_output=True, text=True, timeout=300)
    if probe.returncode != 0:
        fail(f"phase 19: the torch._dynamo import probe exited {probe.returncode}")
    log(f"phase 19: importing torch._dynamo in a fresh process (torch.optim's first use): "
        f"{float(probe.stdout.strip()):.2f} s")
    log(f"phase 19: config 2 CLI at the default config (no -s: the AE, unbanded K2; 100 clips, "
        f"{summary['n_segments']} segments, AE pool {int(summary['counts']['ae_train_frames'])} "
        f"frames, loss {losses[0]:.5f} -> {losses[-1]:.5f}, {manifest['n_clusters']} clusters, "
        f"planted-truth purity {manifest_purity(manifest, truth):.4f}, K2 launches {launches}): "
        f"wall {wall:.2f} s (process incl. start-up); stages {t}")
    # autoencoder.checkpoint: the first run trains and saves, the second
    # restores (no training) and gives the same D bit for bit.
    out, runs = tmp / "config2_ckpt_out", []
    for _ in range(2):
        s_run, w_run, m_run = cli("phase 19", corpus, out, "-s", "autoencoder.checkpoint=true")
        runs.append((s_run, w_run, m_run, np.load(out / "distance_matrix.npy")))
    (s1, w1, m1, D1), (s2, w2, m2, D2) = runs
    if not m1["ae_losses"] or m2["ae_losses"]:
        fail(f"phase 19: checkpoint runs trained {len(m1['ae_losses'])} and "
             f"{len(m2['ae_losses'])} epochs (want 20, then 0: restored)")
    if not np.array_equal(D1, D2):
        fail(f"phase 19: the restored run's D differs (max abs {np.abs(D1 - D2).max()})")
    log(f"phase 19: autoencoder.checkpoint=true: trained and saved in {w1:.2f} s "
        f"(autoencoder_train {s1['timings_s']['autoencoder_train']:.3f} s), restored in "
        f"{w2:.2f} s (autoencoder_train {s2['timings_s']['autoencoder_train']:.3f} s); D bitwise "
        f"equal")
    return {"launches": launches}


def phase20(dev, tmp: Path) -> dict:
    from audio_pattern_discovery_tpu_torch.config import PipelineConfig
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_lane_diag_pairs
    from audio_pattern_discovery_tpu_torch.pipeline import discover
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    corpus = tmp / "seed7"
    if not corpus.is_dir():
        make_corpus(corpus, n_clips=12, n_motifs=3, seed=7)
    cfg = PipelineConfig()
    cfg.dtw.band = 16
    cfg.output.write_snippets = cfg.output.write_images = cfg.output.write_html_report = False
    dtw_tile_lane_diag_pairs.launches = 0
    t0 = time.perf_counter()
    res = discover(corpus, cfg, device=dev)
    wall = time.perf_counter() - t0
    launches = dtw_tile_lane_diag_pairs.launches
    ref = discover(corpus, cfg, device="cpu")
    D, D_cpu = res.distance_matrix, ref.distance_matrix
    if launches < 1:
        fail("phase 20: discover() at the default config with band 16 never launched K1")
    if D.shape != D_cpu.shape or not np.allclose(D, D_cpu, rtol=0, atol=AE_D_ATOL):
        fail(f"phase 20: the card's D differs from the CPU's (max abs {np.abs(D - D_cpu).max()}, "
             f"atol {AE_D_ATOL})")
    if partition(res.labels) != partition(ref.labels):
        fail("phase 20: the card's cluster partition differs from the CPU's")
    t = {k: round(v, 3) for k, v in res.counters.timings_s.items()}
    log(f"phase 20: seed 7 at the default config with band 16 (the AE, K1): K={D.shape[0]}, "
        f"card vs CPU D max abs err {np.abs(D - D_cpu).max():.3g} (atol {AE_D_ATOL}), "
        f"partition equal, {len(res.clusters)} clusters, K1 launches {launches}, loss "
        f"{res.ae_losses[-1]:.5f} (card) vs {ref.ae_losses[-1]:.5f} (CPU); card wall "
        f"{wall:.2f} s, stages {t}")
    # autoencoder.overlap_clip_fraction: the AE trains on the first half's
    # clips on a worker thread (its own stream on the card) while the second
    # half's spectrograms run; the segment table is the single-phase one.
    cfg.autoencoder.overlap_clip_fraction = 0.5
    ov = discover(corpus, cfg, device=dev)
    ov_cpu = discover(corpus, cfg, device="cpu")
    seg = [(s.clip, s.start_frame, s.end_frame) for s in res.segments]
    if [(s.clip, s.start_frame, s.end_frame) for s in ov.segments] != seg:
        fail("phase 20: the two-phase run's segment table differs from the single-phase one")
    D_ov, D_ov_cpu = ov.distance_matrix, ov_cpu.distance_matrix
    if not (ov.ae_losses and np.isfinite(ov.ae_losses).all() and np.isfinite(D_ov).all()):
        fail("phase 20: the two-phase run gave non-finite losses or distances")
    if not np.allclose(D_ov, D_ov_cpu, rtol=0, atol=AE_D_ATOL):
        fail(f"phase 20: the two-phase run's D differs between the card and the CPU (max abs "
             f"{np.abs(D_ov - D_ov_cpu).max()})")
    if partition(ov.labels) != partition(ov_cpu.labels):
        fail("phase 20: the two-phase run's partition differs between the card and the CPU")
    log(f"phase 20: overlap_clip_fraction=0.5: pool {int(ov.counters.counts['ae_train_frames'])} "
        f"of {int(res.counters.counts['ae_train_frames'])} frames, card vs CPU D max abs err "
        f"{np.abs(D_ov - D_ov_cpu).max():.3g}, partition equal; autoencoder_train (the drain) "
        f"{ov.counters.timings_s['autoencoder_train']:.3f} s against "
        f"{res.counters.timings_s['autoencoder_train']:.3f} s single-phase")
    return {"launches": launches}


def seed7_corpus(tmp: Path) -> Path:
    """The seed-7 corpus (phase 3's), made once under ``tmp``."""
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    corpus = tmp / "seed7"
    if not corpus.is_dir():
        make_corpus(corpus, n_clips=12, n_motifs=3, seed=7)
    return corpus


def partition_of(manifest: dict) -> list[tuple[int, ...]]:
    """A clusters.json's cluster partition (segment indices)."""
    return sorted(tuple(sorted(m["segment"] for m in c["members"])) for c in manifest["clusters"])


def phase21(tmp: Path) -> dict:
    import shutil

    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    corpus, _ = config2_corpus(tmp)
    wavs = sorted(corpus.glob("*.wav"))
    grow, out, out_full = tmp / "config2_grow", tmp / "config2_index", tmp / "config2_full"
    grow.mkdir()
    for p in wavs[:90]:
        shutil.copy(p, grow / p.name)
    ck = ("-s", "autoencoder.checkpoint=true")
    s_idx, w_idx, m_idx = cli("phase 21 (index 90)", grow, out, *ck)
    for p in wavs[90:]:
        shutil.copy(p, grow / p.name)
    s_up, w_up, m_up = cli("phase 21 (update)", grow, out, "--update", *ck)
    D_up = np.load(out / "distance_matrix.npy")
    shutil.copytree(out / "ae_ckpt", out_full / "ae_ckpt")
    s_full, w_full, m_full = cli("phase 21 (full run, restored)", grow, out_full, *ck)
    D_full = np.load(out_full / "distance_matrix.npy")
    if m_up["ae_losses"] or m_full["ae_losses"] or not m_idx["ae_losses"]:
        fail("phase 21: the index must train the AE and the update and full run restore it")
    if D_up.shape != D_full.shape or not np.allclose(D_up, D_full, rtol=1e-4, atol=1e-5):
        fail(f"phase 21: the update's D differs from the full run's (max abs "
             f"{np.abs(D_up - D_full).max()})")
    if partition_of(m_up) != partition_of(m_full):
        fail("phase 21: the update's partition differs from the full run's")
    c_up, c_full = s_up["counts"], s_full["counts"]
    k2 = [int(c.get("launches.dtw_tile_pairs", 0)) for c in (c_up, c_full)]
    tp = [int(c["dtw_tile_programs"]) for c in (c_up, c_full)]
    # One launch carries up to 64 tile-pairs: at this size both runs fit
    # one, so the update's smaller share shows in its tile-pairs.
    if not (1 <= k2[0] <= k2[1] and tp[0] < tp[1]):
        fail(f"phase 21: K2 launches update {k2[0]} vs full {k2[1]}, tile-pairs {tp[0]} vs "
             f"{tp[1]}")
    # A held-out clip: clip 100 of the same generator (its first 100 clips
    # are config 2's).
    make_corpus(tmp / "config2_q", n_clips=101, n_motifs=5, occurrences_per_clip=4,
                clip_seconds=10.0, sample_rate=44_100, seed=2)
    qwav = tmp / "config2_q" / "clip_0100.wav"
    report, w_q, _ = cli("phase 21 (query)", None, out, "--query", str(qwav), "--top-k", "5", *ck)
    q0 = report["queries"][0]
    t = {k: round(v, 3) for k, v in s_up["timings_s"].items()}
    log(f"phase 21: config 2 at the default config (the AE), 90 clips indexed in {w_idx:.2f} s "
        f"({s_idx['n_segments']} segments), --update with 10 more in {w_up:.2f} s "
        f"(dtw_pairs_reused {int(c_up['dtw_pairs_reused'])}, dtw_pairs {int(c_up['dtw_pairs'])}; "
        f"stages {t}), the full run from the restored checkpoint in {w_full:.2f} s "
        f"({s_full['n_segments']} segments, dtw_pairs {int(c_full['dtw_pairs'])}); D max abs "
        f"err {np.abs(D_up - D_full).max():.3g}, bitwise {np.array_equal(D_up, D_full)}, "
        f"partition equal; K2 launches {k2[0]} (update) vs {k2[1]} (full), tile-pairs "
        f"{tp[0]} vs {tp[1]}; walls are processes incl. start-up")
    log(f"phase 21: --query clip_0100 --top-k 5: {w_q:.2f} s (process incl. start-up), "
        f"{report['n_query_segments']} query segments against {report['n_corpus_segments']}; "
        f"first segment's best cluster {q0['best_cluster']}, top match segment "
        f"{q0['matches'][0]['segment']} at {q0['matches'][0]['distance']}")
    return {"launches": k2[0]}


def twin_checked(kernel, twin, rtol: float, atol: float, errs: list):
    """``kernel`` as the scheduler calls it, each call held against its
    plain twin on the same arguments on the card (``agree``)."""
    import functools

    @functools.wraps(kernel)
    def run(*args, frames=None, **kw):
        got = kernel(*args, frames=frames, **kw)
        errs.append(agree(f"phase 22 ({kernel.__name__} vs twin, out-of-order tiles)", got,
                          twin(*args, **kw), rtol, atol))
        return got

    return run


def known_config4(tag: str, dev, cfg, kernel, full: tuple | None) -> dict:
    """Config 4 grown by 1,024 sequences: the first 9,216 are the index
    (their distances taken from the full job's D), the last 1,024 new; D
    against the full job's.  Returns the launches and the work."""
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances

    K, S, d, k_old = 10_240, 128, 16, 9_216
    feats, lens = config4_corpus(K, S, d, seed=4, dev=dev)
    lens_np = lens.cpu().numpy()
    if full is None:   # phases 5 and 11 skipped by --phases
        st: dict = {}
        t0 = time.perf_counter()
        D_full = all_pairs_distances(feats, lens_np, cfg, device=dev, stats=st)
        full = (D_full, st, time.perf_counter() - t0)
    D_full, st_full, wall_full = full
    kernel.launches = 0
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D = all_pairs_distances(feats, lens_np, cfg, device=dev, stats=stats,
                            known=(k_old, D_full[:k_old, :k_old]))
    wall = time.perf_counter() - t0
    launches = kernel.launches
    if launches < 1 or not np.isfinite(D).all():
        fail(f"{tag}: {kernel.__name__} launched {launches} times, or D is not finite")
    if not np.allclose(D, D_full, rtol=1e-4, atol=1e-5):
        fail(f"{tag}: the known= D differs from the full job's (max abs "
             f"{np.abs(D - D_full).max()})")
    log(f"{tag}: config 4 grown by 1,024 of {K} ({stats['route']}, known=): "
        f"{stats['tile_programs']} of {st_full['tile_programs']} tile-pairs, {launches} "
        f"{kernel.__name__} launches (full job {st_full['blocks']}), kernel "
        f"{stats['kernel_s']:.3f} s (full {st_full['kernel_s']:.3f} s), wall {wall:.3f} s (full "
        f"{wall_full:.3f} s), scatter {stats['scatter_s']:.3f} s; {stats['pairs']} new pairs; "
        f"D vs the full job: max abs err {np.abs(D - D_full).max():.3g}, bitwise "
        f"{np.array_equal(D, D_full)}")
    return {"launches": launches, "tile_programs": stats["tile_programs"]}


# The out-of-order jobs of phase 22: (route, kernel, config, S, old
# lengths, new lengths).  New sequences are shorter than the old, so the
# grouped sort of known= puts short new tiles against long old ones.  The
# first widen job's classes stay within K4's gate (stripes <= 256 slots);
# the second's spread puts its classes past it, on K5 (its one narrow class,
# new x new, merges into them: too thin to launch alone).
OOO_JOBS = (
    ("diag", "dtw_tile_lane_diag_pairs", dict(band=16, band_mode="diag"), 128, (64, 128),
     (8, 40)),
    ("tile", "dtw_tile_pairs", dict(band=None), 256, (128, 256), (8, 64)),
    ("full", "dtw_tile_lane_full_pairs", dict(band=None), 384, (300, 384), (257, 300)),
    ("widen", "dtw_tile_lane_pairs", dict(band=16, band_mode="widen"), 128, (80, 128), (8, 40)),
    ("widen", "dtw_tile_stripe_pairs", dict(band=16, band_mode="widen"), 256, (180, 256),
     (8, 60)),
)


def ooo_jobs(dev) -> dict:
    """Each tiled route on K=384 sequences (3 tiles of 128: old, boundary,
    new) with known= (k_old 224) on the card: every chunk each kernel
    launches held against its plain twin on the card, D against the full
    job's on sorted tiles and 256 new pairs against the plain ``dtw_batch``.
    Returns {kernel name: launches}."""
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.ops import dtw_cuda as tk
    from audio_pattern_discovery_tpu_torch.ops.dtw import dtw_batch
    from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as tps

    twins = {
        "dtw_tile_lane_diag_pairs": (tk.dtw_tile_lane_diag_pairs_ref, K1_RTOL, K1_ATOL),
        "dtw_tile_pairs": (tk.dtw_tile_pairs_ref, K2_RTOL, K2_ATOL),
        "dtw_tile_lane_full_pairs": (tk.dtw_tile_lane_full_pairs_ref, K3_RTOL, K3_ATOL),
        "dtw_tile_lane_pairs": (tk.dtw_tile_lane_pairs_ref, K4_RTOL, K4_ATOL),
        "dtw_tile_stripe_pairs": (tk.dtw_tile_lane_pairs_ref, K5_RTOL, K5_ATOL),
    }
    K, k_old, d = 384, 224, 16
    launched: dict[str, int] = {}
    for n, (route, kernel, kw, S, old, new) in enumerate(OOO_JOBS):
        cfg = DTWConfig(normalize="path_len", **kw)
        g = torch.Generator(device=dev).manual_seed(220 + n)
        lens = torch.cat([torch.randint(old[0], old[1] + 1, (k_old,), generator=g, device=dev),
                          torch.randint(new[0], new[1] + 1, (K - k_old,), generator=g,
                                        device=dev)]).to(torch.int32)
        feats = torch.randn((K, S, d), generator=g, device=dev)
        feats *= torch.arange(S, device=dev)[None, :, None] < lens[:, None, None]
        lens_np = lens.cpu().numpy()
        D_full = tps.all_pairs_distances(feats, lens_np, cfg, device=dev)
        errs: list[float] = []
        real = {name: getattr(tps, name) for name in twins}
        counts0 = {name: fn.launches for name, fn in real.items()}
        for name, (twin, rtol, atol) in twins.items():
            setattr(tps, name, twin_checked(real[name], twin, rtol, atol, errs))
        stats: dict = {}
        try:
            D = tps.all_pairs_distances(feats, lens_np, cfg, device=dev, stats=stats,
                                        known=(k_old, D_full[:k_old, :k_old]))
        finally:
            for name, fn in real.items():
                setattr(tps, name, fn)
        ran = {name: fn.launches - counts0[name] for name, fn in real.items()
               if fn.launches != counts0[name]}
        if stats["route"] != route or set(ran) != {kernel} or len(errs) != sum(ran.values()):
            fail(f"phase 22: the out-of-order {route} job launched {ran} on route "
                 f"{stats['route']} ({len(errs)} twin checks)")
        if not np.allclose(D, D_full, rtol=1e-4, atol=1e-5):
            fail(f"phase 22: the out-of-order {route} job's D differs from the sorted full job's "
                 f"(max abs {np.abs(D - D_full).max()})")
        rng = np.random.default_rng(22 + n)
        ia = rng.integers(k_old, K, 256)
        ib = rng.integers(0, K, 256)
        sa, sb = torch.from_numpy(ia).to(dev), torch.from_numpy(ib).to(dev)
        plain = dtw_batch(feats[sa], feats[sb], lens[sa], lens[sb], normalize="path_len",
                          band=cfg.band, band_mode=cfg.band_mode).cpu().numpy()
        plain[ia == ib] = 0.0
        if not np.allclose(D[ia, ib], plain, rtol=1e-4, atol=1e-5):
            fail(f"phase 22: the out-of-order {route} job disagrees with plain dtw_batch (max abs "
                 f"{np.abs(D[ia, ib] - plain).max()})")
        for name, n_l in ran.items():
            launched[name] = launched.get(name, 0) + n_l
        log(f"phase 22: out-of-order {route} job (S={S}, old {old[0]}-{old[1]}, new "
            f"{new[0]}-{new[1]} frames, known= k_old {k_old} of {K}): launches {ran}, each "
            f"chunk vs its twin on the card max abs err {max(errs):.3g}; D vs the sorted full "
            f"job max abs err {np.abs(D - D_full).max():.3g}; 256 new pairs match plain "
            f"dtw_batch")
    return launched


def phase22(dev, keep: dict) -> dict:
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
        dtw_tile_lane_diag_pairs,
        dtw_tile_pairs,
    )

    res = {
        "dtw_tile_lane_diag_pairs": known_config4(
            "phase 22 (diag)", dev, DTWConfig(band=16, band_mode="diag", normalize="path_len"),
            dtw_tile_lane_diag_pairs, keep.get("diag")),
        "dtw_tile_pairs": known_config4(
            "phase 22 (unbanded)", dev, DTWConfig(band=None, normalize="path_len"),
            dtw_tile_pairs, keep.get("tile")),
    }
    keep.clear()
    return {"config4": res, "ooo": ooo_jobs(dev)}


def phase23(dev) -> dict:
    """The per-pair route with known= (``new_from``): the config-4 slice
    K=2,048 and 256 sequences of 900-1024 frames, widen band 16 and
    unbanded, the first 7/8 of each job old; D against the tiled full D."""
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import _dtw_batch_stripe, dtw_batch_pallas
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances

    feats, lens = config4_corpus(10_240, 128, 16, seed=4, dev=dev)
    long_feats, long_lens = sorted_corpus(256, 1024, 16, 900, 1024, seed=16, dev=dev)
    totals = {"dtw_batch_pallas": 0, "_dtw_batch_stripe": 0}
    for name, f, n in (("config-4 slice K=2048", feats[:2048], lens[:2048]),
                       ("lengths 900-1024 K=256", long_feats, long_lens)):
        n_np = n.cpu().numpy()
        k_old = len(n_np) * 7 // 8
        for band in (16, None):
            cfg = DTWConfig(band=band, band_mode="widen", normalize="path_len")
            mode = "unbanded" if band is None else "widen band 16"
            full = all_pairs_distances(f, n_np, cfg, device=dev)
            before = (dtw_batch_pallas.launches, _dtw_batch_stripe.launches)
            stats: dict = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            D = all_pairs_distances(f, n_np, cfg, device=dev, tiled=False, stats=stats,
                                    known=(k_old, full[:k_old, :k_old]))
            wall = time.perf_counter() - t0
            k6_n = dtw_batch_pallas.launches - before[0]
            k7_n = _dtw_batch_stripe.launches - before[1]
            totals["dtw_batch_pallas"] += k6_n
            totals["_dtw_batch_stripe"] += k7_n
            if k6_n + k7_n < 1 or (f is long_feats and (k6_n if band is None else k7_n) < 1):
                fail(f"phase 23: the per-pair known= job ({name}, {mode}) launched K6 {k6_n} "
                     f"and K7 {k7_n} times")
            if not np.isfinite(D).all() or not np.allclose(D, full, rtol=1e-4, atol=1e-5):
                fail(f"phase 23: the per-pair known= D ({name}, {mode}) differs from the tiled "
                     f"full D (max abs {np.abs(D - full).max()})")
            by = stats["kernel_s_by"]
            log(f"phase 23: per-pair route with known= (new_from {k_old}), {name}, {mode}: "
                f"{stats['pairs']} new pairs in {wall:.3f} s, {stats['blocks']} blocks ({k6_n} K6, "
                f"{k7_n} K7 launches; K6 {by.get('dtw_batch_pallas', 0.0):.4f} s, K7 "
                f"{by.get('_dtw_batch_stripe', 0.0):.4f} s of device time); D vs the tiled full D "
                f"max abs err {np.abs(D - full).max():.3g}")
    return totals


def phase24(dev, tmp: Path) -> dict:
    """Block resume: discover() on seed 7 with parallel.checkpoint_blocks
    twice (K1), and the per-pair config-4 slice with block_dir twice (K6):
    each second run launches no DTW kernel and gives the same D bit for
    bit."""
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_batch_pallas
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances
    from audio_pattern_discovery_tpu_torch.pipeline import DTW_KERNELS, discover

    cfg = golden_config()
    cfg.parallel.checkpoint_blocks = True
    out = tmp / "resume_out"
    runs = []
    for _ in range(2):
        for k in DTW_KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        res = discover(seed7_corpus(tmp), cfg, out_dir=out, device=dev)
        runs.append((res, sum(k.launches for k in DTW_KERNELS), time.perf_counter() - t0))
    (r1, n1, w1), (r2, n2, w2) = runs
    blocks = int(r1.counters.counts["dtw_kernel_launches"])
    if n1 < 1 or n2 != 0 or int(r2.counters.counts["dtw_blocks_resumed"]) != blocks:
        fail(f"phase 24: discover() with checkpoint_blocks launched {n1} then {n2} DTW kernels "
             f"({int(r2.counters.counts['dtw_blocks_resumed'])} blocks read back)")
    if not np.array_equal(r1.distance_matrix, r2.distance_matrix):
        fail("phase 24: the resumed discover()'s D differs")
    feats, lens = config4_corpus(10_240, 128, 16, seed=4, dev=dev)
    lens_np = lens[:2048].cpu().numpy()
    cfg_pp = DTWConfig(band=16, band_mode="widen", normalize="path_len")
    pp = []
    for _ in range(2):
        dtw_batch_pallas.launches = 0
        stats: dict = {}
        t0 = time.perf_counter()
        D = all_pairs_distances(feats[:2048], lens_np, cfg_pp, device=dev, tiled=False,
                                block_dir=tmp / "resume_pp", stats=stats)
        pp.append((D, dtw_batch_pallas.launches, stats, time.perf_counter() - t0))
    (D1, k1, s1, pw1), (D2, k2, s2, pw2) = pp
    if k1 < 1 or k2 != 0 or s2["blocks_resumed"] != s2["blocks"] or not np.array_equal(D1, D2):
        fail(f"phase 24: the per-pair job with block_dir launched K6 {k1} then {k2} times "
             f"({s2['blocks_resumed']} of {s2['blocks']} blocks read back), D equal "
             f"{np.array_equal(D1, D2)}")
    log(f"phase 24: block resume: discover() on seed 7 (checkpoint_blocks) {blocks} K1 "
        f"launches in {w1:.2f} s, then 0 launches "
        f"({int(r2.counters.counts['dtw_blocks_resumed'])} blocks read back) in {w2:.2f} s, D "
        f"bitwise equal; per-pair config-4 slice (block_dir) {k1} K6 launches in {pw1:.3f} s "
        f"(persist {s1['persist_s']:.3f} s), then 0 ({s2['blocks']} blocks read back) in "
        f"{pw2:.3f} s, D bitwise equal")
    return {"launches": n1}


def phase25(tmp: Path) -> dict:
    """The resident worker: ``--serve`` as a subprocess on the card; ping,
    discover on seed 7, the same query twice, doctor's report (with the
    device probes) and a shutdown.  The served D equals the CLI's bit for
    bit."""
    from audio_pattern_discovery_tpu_torch.serve import request
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    cfg = golden_config()
    cfg.autoencoder.checkpoint = True     # a query needs the index's embedder
    cfg_path = tmp / "serve_cfg.json"
    cfg.to_json(cfg_path)
    make_corpus(tmp / "seed7_q", n_clips=13, n_motifs=3, seed=7)
    qwav = tmp / "seed7_q" / "clip_0012.wav"
    sock = tmp / "apd.sock"
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "audio_pattern_discovery_tpu_torch",
                             "--serve", str(sock)], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        while True:
            if proc.poll() is not None:
                fail(f"phase 25: the worker exited {proc.returncode} at start-up:\n"
                     f"{proc.stderr.read()[-3000:]}")
            if time.perf_counter() - t0 > 300:
                fail("phase 25: the worker never answered ping")
            try:
                pong = request(sock, {"cmd": "ping"}, timeout=10)
                break
            except OSError:
                time.sleep(0.1)
        start_s = time.perf_counter() - t0
        walls, results = [], []
        discover_req = {"cmd": "discover", "wav_dir": str(seed7_corpus(tmp)),
                        "out_dir": str(tmp / "serve_out"), "config": cfg.to_dict()}
        query_req = {"cmd": "query", "out_dir": str(tmp / "serve_out"), "wavs": [str(qwav)],
                     "top_k": 5, "config": cfg.to_dict()}
        # A request that fails between two device jobs must leave the worker
        # (and its CUDA context) serving the next.
        bad_req = {**discover_req, "out_dir": str(tmp / "serve_bad"),
                   "overrides": {"dtw.nonexistent_knob": 1}}
        for req in (discover_req, bad_req, query_req, query_req):
            t1 = time.perf_counter()
            r = request(sock, req, timeout=300)
            wall = time.perf_counter() - t1
            if req is bad_req:
                if r["ok"]:
                    fail("phase 25: a discover request with an unknown config key succeeded")
                continue
            if not r["ok"]:
                fail(f"phase 25: the {req['cmd']} request failed: {r.get('traceback', r)}")
            walls.append(wall)
            results.append(r["result"])
        doctor = request(sock, {"cmd": "doctor", "probe_device": True}, timeout=120)
        if not doctor["ok"] or "error" in doctor["result"].get("device", {"error": None}):
            fail(f"phase 25: doctor answered {doctor}")
        if not request(sock, {"cmd": "ping"}, timeout=30)["ok"]:
            fail("phase 25: the worker stopped answering after doctor's report")
        bye = request(sock, {"cmd": "shutdown"}, timeout=60)
        proc.wait(timeout=120)
        if not bye["ok"] or proc.returncode != 0:
            fail(f"phase 25: shutdown answered {bye}, the worker exited {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    if results[1] != results[2]:
        fail("phase 25: the same query gave two reports")
    counts = results[0]["counts"]
    if int(counts.get("launches.dtw_tile_lane_diag_pairs", 0)) < 1:
        fail("phase 25: the served discover never launched K1")
    _, w_cli, _ = cli("phase 25 (CLI)", tmp / "seed7", tmp / "serve_cli_out", "-c", str(cfg_path))
    D_srv = np.load(tmp / "serve_out" / "distance_matrix.npy")
    D_cli = np.load(tmp / "serve_cli_out" / "distance_matrix.npy")
    if not np.array_equal(D_srv, D_cli):
        fail(f"phase 25: the served D differs from the CLI's (max abs {np.abs(D_srv - D_cli).max()})")
    q = results[1]["queries"][0]
    log(f"phase 25: --serve on {pong['result']['device']}: start-up to the first ping "
        f"{start_s:.2f} s; discover (seed 7, band 16, K1 launches "
        f"{int(counts['launches.dtw_tile_lane_diag_pairs'])}) {walls[0]:.3f} s, a failing "
        f"request, then the same query {walls[1]:.3f} s and {walls[2]:.3f} s (best cluster "
        f"{q['best_cluster']}); the CLI's "
        f"process for the same discover {w_cli:.2f} s; served D bitwise the CLI's; doctor: "
        f"{json.dumps({k: doctor['result']['device'][k] for k in DOCTOR_PROBES})}")
    return {"launches": int(counts["launches.dtw_tile_lane_diag_pairs"])}


def phase26(dev, tmp: Path) -> dict:
    """autoencoder.context_frames=2 and spectrogram.upload_codec=mulaw8, each
    through discover() on seed 7 (the golden config: PCA, band 16) on the
    card and on the CPU: D at rtol 1e-4 / atol 1e-5, partition exact."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_lane_diag_pairs
    from audio_pattern_discovery_tpu_torch.pipeline import discover

    for over in ({"autoencoder.context_frames": 2}, {"spectrogram.upload_codec": "mulaw8"}):
        cfg = golden_config().override(over)
        dtw_tile_lane_diag_pairs.launches = 0
        res = discover(seed7_corpus(tmp), cfg, device=dev)
        launches = dtw_tile_lane_diag_pairs.launches
        ref = discover(seed7_corpus(tmp), cfg, device="cpu")
        D, D_cpu = res.distance_matrix, ref.distance_matrix
        if launches < 1:
            fail(f"phase 26 ({over}): discover() never launched K1")
        if D.shape != D_cpu.shape or not np.allclose(D, D_cpu, rtol=1e-4, atol=1e-5):
            fail(f"phase 26 ({over}): the card's D differs from the CPU's (max abs "
                 f"{np.abs(D - D_cpu).max()})")
        if partition(res.labels) != partition(ref.labels):
            fail(f"phase 26 ({over}): the card's partition differs from the CPU's")
        t = {k: round(v, 4) for k, v in res.counters.timings_s.items()
             if k in ("spectrogram", "context_stack", "embedding_fit", "embedding_encode")}
        log(f"phase 26: {over} on seed 7: K={D.shape[0]}, card vs CPU D max abs err "
            f"{np.abs(D - D_cpu).max():.3g}, partition equal, K1 launches {launches}; card "
            f"stages {t}")
    return {}


# Phase 27's sweeps (metrics, frame widths, blocks 64 and 128, an
# out-of-frame call) run at this padded length: the twin takes one
# dependent step per cell anti-diagonal of each block, ~32,000 steps a call
# at S=8192 and ~7,700 at 2048.
K8_SWEEP_S = 2048


def long_pairs(dev, B: int, S: int, d: int, lo: int, seed: int, near: int = 0):
    """K8's arguments for B pairs padded to S frames, lengths in [lo, S];
    the first ``near`` pairs with |la - lb| <= 12 (inside a hard band 16),
    the rest independent."""
    g = torch.Generator(device=dev).manual_seed(seed)
    la = torch.randint(lo, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    lb = torch.randint(lo, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    lb[:near] = (la[:near] + torch.randint(-12, 13, (near,), generator=g, device=dev,
                                           dtype=torch.int32)).clamp(lo, S)
    return (torch.randn((B, S, d), generator=g, device=dev),
            torch.randn((B, S, d), generator=g, device=dev), la, lb)


# K8's readings against its twin this run: tag -> the largest relative
# difference over the pairs whose distance is past 1 (cosine costs near 0
# are the atol's).
K8_READINGS: dict[str, float] = {}


def k8_reading(tag: str, got, want) -> None:
    fin = torch.isfinite(want) & torch.isfinite(got) & (want.abs() > 1)
    K8_READINGS[tag] = float(((got - want).abs() / want.abs())[fin].max()) if bool(fin.any()) \
        else 0.0


def k8_check(tag: str, args, **kw) -> tuple[float, float]:
    """K8 against its twin on the card (the launches counted): the max abs
    error and the twin's ms (CUDA events around the call)."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_long import dtw_long_batch, dtw_long_batch_ref

    n0 = dtw_long_batch.launches
    got = dtw_long_batch(*args, **kw)
    torch.cuda.synchronize()
    if dtw_long_batch.launches == n0:
        fail(f"{tag}: K8 did not launch")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    want = dtw_long_batch_ref(*args, **kw)
    ev[1].record()
    torch.cuda.synchronize()
    k8_reading(tag, got, want)
    return agree(tag, got, want, K8_RTOL, K8_ATOL), ev[0].elapsed_time(ev[1])


def k8_witness(tag: str, args, **kw) -> str:
    """K8 bit for bit against K6 (unbanded, S <= 1024) or K7 (a band, pairs
    within class 63, S <= 4096): the same systolic walk over the same costs
    (``apd_systolic::cost_of``), each cell cost + min(min(diag, up), left).
    Returns the witness's name."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import _dtw_batch_stripe, dtw_batch_pallas
    from audio_pattern_discovery_tpu_torch.ops.dtw_long import dtw_long_batch

    got = dtw_long_batch(*args, **kw)
    metric = kw.get("metric", "euclidean")
    if kw.get("band") is None:
        name, want = "K6", dtw_batch_pallas(*args, metric=metric)
    else:
        name, want = "K7", _dtw_batch_stripe(*args, metric=metric, band=kw["band"],
                                             auto_widen=kw.get("auto_widen", True),
                                             max_len_diff=63)
    if not torch.equal(got, want):
        fin = torch.isfinite(want)
        fail(f"{tag}: K8 and {name} differ on {int((got != want).sum())} of {len(got)} pairs "
             f"(max abs {float((got - want)[fin].abs().max()) if bool(fin.any()) else 'inf'})")
    return name


def k8_stripes(tag: str, args, **kw) -> None:
    """K8 run as two stripes of block columns, [0, nB/2) with no halo and
    [nB/2, nB) with the first stripe's right columns as its halo (the
    interface the multi-GPU wavefront launches per device), bit for bit
    against the whole grid in one stripe."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import INF, frame_layout
    from audio_pattern_discovery_tpu_torch.ops.dtw_long import long_block_columns

    a, b, la, lb = args
    blk = kw.pop("block", 256)
    nB = a.shape[1] // blk
    metric = kw.get("metric", "euclidean")
    xa, xb = frame_layout(a, metric), frame_layout(b, metric)
    whole = torch.full((len(la),), INF, device=a.device)
    V = long_block_columns(xa, xb, la, lb, whole, block=blk, J0=0, nJ=nB, **kw)
    split = torch.full((len(la),), INF, device=a.device)
    halo = long_block_columns(xa, xb, la, lb, split, block=blk, J0=0, nJ=nB // 2, **kw)
    V2 = long_block_columns(xa, xb, la, lb, split, block=blk, J0=nB // 2, nJ=nB - nB // 2,
                            halo=halo, **kw)
    if not (torch.equal(whole, split) and torch.equal(V, V2)):
        fail(f"{tag}: two stripes of block columns with a halo differ from the whole grid "
             f"({int((whole != split).sum())} distances, {int((V != V2).sum())} right-column "
             "entries)")


def phase27(dev) -> dict:
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import strip_channels
    from audio_pattern_discovery_tpu_torch.ops.dtw_long import (
        _long_config,
        _long_rows,
        dtw_long_batch,
        dtw_long_batch_ref,
    )

    # 64 pairs at S=8192 (lengths 4097-8192, block 256), the first 32 within
    # a hard band 16 of each other: unbanded, widen 16 with auto_widen on and
    # off (off: +inf on exactly the pairs whose corner leaves the band), diag.
    S, d = 8192, 16
    args = long_pairs(dev, 64, S, d, 4097, seed=27, near=32)
    errs, plain = {}, {}
    for mode, kw in (("unbanded", dict(band=None)), ("widen 16", dict(band=16)),
                     ("hard 16", dict(band=16, auto_widen=False)),
                     ("diag 16", dict(band=16, band_mode="diag"))):
        errs[mode], plain[mode] = k8_check(f"phase 27 (S={S}, {mode})", args, **kw)
    hard = dtw_long_batch(*args, band=16, auto_widen=False)
    over = (args[2] - args[3]).abs() > 16
    if not (bool(torch.isinf(hard[over]).all()) and bool(torch.isfinite(hard[~over]).all())):
        fail("phase 27: a hard band 16 did not give +inf on exactly the pairs outside it")
    # The sweeps at K8_SWEEP_S against the twin: the metrics on 8 pairs,
    # every frame width K8 is built for on 4, blocks of 64 and 128 frames,
    # a single block, and a call whose pairs are all out of frame (an empty
    # side, a side past S).  Each sweep point is also held bit for bit
    # against K7 (widen 16 at S=2048 on pairs within 12 frames of each
    # other, so inside K7's class 63) and K6 (unbanded at S=1024).
    Sw = K8_SWEEP_S
    done, witnessed = [], set()

    def witness(tag: str, B: int, dd: int, seed: int, **kw) -> None:
        near = long_pairs(dev, B, Sw, dd, Sw // 2, seed=seed, near=B)
        witnessed.add(k8_witness(f"{tag}, widen 16", near, band=16, **kw))
        witnessed.add(k8_witness(f"{tag}, hard 16", near, band=16, auto_widen=False, **kw))
        short = long_pairs(dev, B, 1024, dd, 512, seed=seed + 1)
        witnessed.add(k8_witness(f"{tag}, unbanded at S=1024", short, **kw))

    for metric in ("euclidean", "sqeuclidean", "cosine"):
        k8_check(f"phase 27 ({metric})", long_pairs(dev, 8, Sw, d, Sw // 2, seed=270),
                 metric=metric)
        witness(f"phase 27 ({metric})", 8, d, 280, metric=metric)
        done.append(f"{metric}")
    for dd in SWEEP_DIMS:
        k8_check(f"phase 27 (d={dd})", long_pairs(dev, 4, Sw, dd, Sw // 2, seed=271 + dd))
        witness(f"phase 27 (d={dd})", 4, dd, 281 + dd)
        done.append(f"d={dd} ({strip_channels(dd)} float4s, R={_long_rows(256, strip_channels(dd))})")
    # Past the staged rings: B through the cache, fewer warps at the widest.
    for dd, blk in ((64, 256), (128, 256), (396, 256), (64, 64)):
        nc4 = strip_channels(dd)
        cfg = _long_config(_long_rows(blk, nc4), nc4, blk)
        k8_check(f"phase 27 (d={dd}, block {blk})",
                 long_pairs(dev, 4, Sw, dd, Sw // 2, seed=271 + dd + blk), block=blk)
        done.append(f"d={dd} block {blk} ({cfg[0]} warps, B {'staged' if cfg[1] else 'cached'})")
    for blk in (64, 128):
        k8_check(f"phase 27 (block {blk})", long_pairs(dev, 8, Sw, d, Sw // 2, seed=272 + blk),
                 block=blk)
        witness(f"phase 27 (block {blk})", 8, d, 282 + blk, block=blk)
        done.append(f"block {blk} (R={_long_rows(blk, strip_channels(d))})")
    # The block-column range and the halo: two stripes against the whole grid.
    for mode, kw in (("unbanded", {}), ("diag 16", dict(band=16, band_mode="diag"))):
        k8_stripes(f"phase 27 (stripes, {mode})", long_pairs(dev, 8, Sw, d, Sw // 4, seed=278),
                   **kw)
    k8_check("phase 27 (a single block)", long_pairs(dev, 8, 256, d, 1, seed=273), block=256)
    # Out of frame: an empty side or a side past S (no block of K8's: +inf),
    # beside one pair in frame (so the call launches).
    a, b, _, _ = long_pairs(dev, 5, Sw, d, 1, seed=274)
    oof = (a, b, torch.tensor([0, 1000, Sw + 1, 1000, 1500], dtype=torch.int32, device=dev),
           torch.tensor([1000, 0, 1000, Sw + 1, 1200], dtype=torch.int32, device=dev))
    k8_check("phase 27 (out of frame)", oof)
    got_oof = dtw_long_batch(*oof)
    if not (bool(torch.isinf(got_oof[:4]).all()) and bool(torch.isfinite(got_oof[4]))):
        fail("phase 27: pairs with an empty side or a side past S did not come back +inf")
    # The corner: each of 8 sequences of 769-1024 frames against itself on a
    # grid of 4 x 4 blocks.  The optimal path is the main diagonal, which
    # crosses from block (I-1, I-1) into (I, I) only through the corner:
    # every distance is exactly 0, and a corner from the wrong step is not.
    g = torch.Generator(device=dev).manual_seed(275)
    x = torch.randn((8, 1024, d), generator=g, device=dev)
    n = torch.randint(769, 1025, (8,), generator=g, device=dev, dtype=torch.int32)
    self_d = dtw_long_batch(x, x, n, n, block=256)
    if not bool((self_d == 0).all()) or not bool((dtw_long_batch_ref(x, x, n, n) == 0).all()):
        fail(f"phase 27: a sequence against itself is not exactly 0: {self_d.tolist()}")
    # 4 pairs at S=16,384: the kernel's memory is boundaries only.
    big = long_pairs(dev, 4, 16_384, d, 12_000, seed=276)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k8_check("phase 27 (S=16384)", big)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dtw_long_batch(*big)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    boundaries = 4 * (2 * 64 * 256 + 2 * 65) * 4
    if extra > 4 * boundaries + (1 << 20):
        fail(f"phase 27: K8 at S=16384 took {extra} bytes beyond its inputs (boundaries "
             f"{boundaries} bytes)")
    del big
    merged = k8_merged(dev)
    # Timed: the kernel line at the 64 pairs above (unbanded, the twin on the
    # same inputs), and at the route's launch size, 512 pairs at bucket 8192
    # (longer side 8161-8192), unbanded and widen 16.
    res = {"max_abs_err": max(errs.values()), "plain_ms": plain["unbanded"]}
    res["ms"] = cuda_ms(lambda: dtw_long_batch(*args), 3)
    cells = float(pair_cells(args[2], args[3], "full").sum())
    res["bound_ms"], res["bound_by"] = bound(cells, d, pair_bytes(args[2], args[3], d))
    log(f"phase 27: K8 vs plain on 64 pairs at S={S} (lengths 4097-8192, block 256): max abs err "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})} (rtol "
        f"{K8_RTOL:.3g}, atol {K8_ATOL}); hard band +inf on exactly the pairs outside it; "
        f"at S={Sw} {done} agree, and each is bitwise equal to {sorted(witnessed)} (widen 16 "
        f"and hard 16 at S={Sw}, unbanded at S=1024); two stripes of block columns with a halo "
        f"bitwise equal to the whole grid (S={Sw}, unbanded and diag 16); a single block "
        f"agrees; out-of-frame pairs +inf; 8 sequences against themselves on 4 x 4 blocks "
        f"exactly 0")
    log(f"phase 27: K8 vs its twin, largest relative difference per check (distances past 1; "
        f"limit {K8_RTOL:.3g}): {json.dumps({k: float(f'{v:.3g}') for k, v in K8_READINGS.items()})}")
    log(f"phase 27: K8 at S=16384 (4 pairs) agrees with its twin and took {extra} bytes beyond "
        f"its inputs (H, V and corners {boundaries} bytes; an [S, S] cost matrix would be "
        f"{16_384 ** 2 * 4} bytes a pair)")
    log(f"phase 27: {merged}")
    log(f"phase 27: K8 shared memory per CUDA block: {k8_smem()}")
    log(f"phase 27: K8 {res['ms']:.3f} ms/call on the 64 pairs ({cells:.4g} cells, "
        f"{rate_line(res['ms'], cells, res['bound_ms'])}), plain {res['plain_ms']:.3f} ms/call, "
        f"{2 * (S // 256) - 1} launches a call")
    # B staged in rings against B through the cache, on the same 64 pairs
    # at d=16 and at d=64 (the same lengths), and at d=16 a warp per pass
    # against one warp walking both passes, in turns.
    wide = (torch.randn((64, S, 64), generator=torch.Generator(device=dev).manual_seed(2764),
                        device=dev),) * 2 + args[2:]
    for dd, pairs in ((d, args), (64, wide)):
        nc4 = strip_channels(dd)
        chosen = _long_config(_long_rows(256, nc4), nc4, 256)
        others = ((chosen[0], not chosen[1]),) + (((1, chosen[1]),) if dd == d else ())
        ms = k8_configs(f"phase 27 (d={dd})", pairs, (chosen, *others))
        b_ms, _ = bound(cells, dd, pair_bytes(args[2], args[3], dd))
        log(f"phase 27: K8 on the 64 pairs at d={dd}: " + "; ".join(
            f"{w} warps, B {'staged' if st else 'cached'}{' (chosen)' if (w, st) == chosen else ''}"
            f" {spread(t)}, {b_ms / sorted(t)[len(t) // 2]:.1%} of the bound {b_ms:.3f} ms"
            for (w, st), t in ms.items()))
    del args, wide
    g = torch.Generator(device=dev).manual_seed(277)
    la = torch.randint(4097, S + 1, (512,), generator=g, device=dev, dtype=torch.int32)
    lb = torch.randint(S - 31, S + 1, (512,), generator=g, device=dev, dtype=torch.int32)
    big_args = (torch.randn((512, S, d), generator=g, device=dev),
                torch.randn((512, S, d), generator=g, device=dev), la, lb)
    for mode, kw, kind in (("unbanded", dict(band=None), "full"),
                           ("widen 16", dict(band=16), "widen")):
        times: list[float] = []
        cuda_ms(lambda: dtw_long_batch(*big_args, **kw), 3, per_call=times)
        c = float(pair_cells(la, lb, kind, 16).sum())
        b_ms, by = bound(c, d, pair_bytes(la, lb, d))
        med = sorted(times)[len(times) // 2]
        log(f"phase 27: K8 at the route's launch size (512 pairs, bucket {S}, {mode}): "
            f"{spread(times)}, {c:.4g} cells, bound {b_ms:.3f} ms ({by}), {b_ms / med:.1%} of it")
    return res


def k8_configs(tag: str, args, configs) -> dict:
    """K8 unbanded on the same pairs (blocks of 256) under each (warps,
    stage_b) of ``configs``, in turns (in order, then back, 3 calls each
    time): each one's ms per call, the distances bitwise equal."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import INF, frame_layout
    from audio_pattern_discovery_tpu_torch.ops.dtw_long import _launch_plan, _long_plan

    a, b, la, lb = args
    xa, xb = frame_layout(a, "euclidean"), frame_layout(b, "euclidean")
    idx = np.arange(len(la))
    plan = _long_plan(idx, idx, la.cpu().numpy(), lb.cpu().numpy(), a.shape[1], b.shape[1], 256)
    outs, times = {}, {}

    def run(cfg):
        out = torch.full((len(la),), INF, device=a.device)
        _launch_plan(xa, xb, plan, out, BLK=256, J0=0, halo=None, metric="euclidean", band=None,
                     auto_widen=True, band_mode="widen", config=cfg)
        return out

    for cfg in (*configs, *configs[::-1]):
        outs[cfg] = run(cfg)
        cuda_ms(lambda: run(cfg), 3, per_call=times.setdefault(cfg, []))
    if not all(torch.equal(outs[configs[0]], o) for o in outs.values()):
        fail(f"{tag}: K8's configurations {list(outs)} give different distances")
    return times


def k8_merged(dev) -> str:
    """The merged call (``dtw_long_pairs``) on 40 pairs by index into one
    corpus of 16 sequences of 300-2,048 frames: launches max(nBa + nBb - 1)
    over its pairs, each distance bit for bit K8 on that pair alone on its
    own padded grid (``dtw_long_batch``), unbanded, widen 16 and diag 16;
    unbanded within ``K8_RTOL`` of the merged twin."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_long import (
        dtw_long_batch,
        dtw_long_pairs,
        dtw_long_pairs_ref,
    )

    g = torch.Generator(device=dev).manual_seed(279)
    K, S, d, blk = 16, 2048, 16, 256
    n = torch.randint(300, S + 1, (K,), generator=g, device=dev, dtype=torch.int32)
    x = torch.randn((K, S, d), generator=g, device=dev)
    ia = torch.randint(0, K, (40,), generator=g, device=dev)
    ib = (ia + torch.randint(1, K, (40,), generator=g, device=dev)) % K
    nb = (n.long() + blk - 1) // blk
    want_launches = int((nb[ia] + nb[ib] - 1).max())
    for mode, kw in (("unbanded", dict(band=None)), ("widen 16", dict(band=16)),
                     ("diag 16", dict(band=16, band_mode="diag"))):
        n0 = dtw_long_batch.launches
        got = dtw_long_pairs(x, n, ia, ib, block=blk, **kw)
        torch.cuda.synchronize()
        if dtw_long_batch.launches - n0 != want_launches:
            fail(f"phase 27: the merged K8 call ({mode}) launched "
                 f"{dtw_long_batch.launches - n0} times; want {want_launches}")
        alone = []
        for p in range(len(ia)):
            Sp = int(torch.maximum(nb[ia[p]], nb[ib[p]])) * blk
            alone.append(dtw_long_batch(x[ia[p : p + 1], :Sp], x[ib[p : p + 1], :Sp],
                                        n[ia[p : p + 1]], n[ib[p : p + 1]], block=blk, **kw))
        alone = torch.cat(alone)
        if not torch.equal(got, alone):
            fail(f"phase 27: the merged K8 call ({mode}) differs from K8 pair by pair on "
                 f"{int((got != alone).sum())} of {len(got)} pairs")
        if mode == "unbanded":
            want = dtw_long_pairs_ref(x, n, ia.cpu().numpy(), ib.cpu().numpy(), feats_b=x,
                                      lengths_b=n, normalize="none", block=blk,
                                      metric="euclidean", band=None, auto_widen=True,
                                      band_mode="widen")
            k8_reading("phase 27 (merged, unbanded)", got, want)
            agree("phase 27 (merged vs its twin)", got, want, K8_RTOL, K8_ATOL)
    return (f"the merged call on 40 pairs of 300-2,048 frames by index into one corpus launched "
            f"{want_launches} times (max nBa + nBb - 1) a mode and is bitwise K8 pair by pair "
            f"on each pair's own grid (unbanded, widen 16, diag 16), unbanded within the twin's "
            f"limit ({K8_READINGS['phase 27 (merged, unbanded)']:.3g} relative)")


def k8_smem() -> str:
    """K8's shared memory per CUDA block: the static bytes ptxas reports and
    the dynamic bytes the wrapper asks for at blocks of 256 frames."""
    from audio_pattern_discovery_tpu_torch.ops import _build
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import strip_channels
    from audio_pattern_discovery_tpu_torch.ops.dtw_long import _long_config, _long_rows, _long_smem

    ptxas = _build.build_info.get("dtw_long_block", (0.0, ""))[1]
    static = max((int(m) for m in re.findall(r"(\d+) bytes smem", ptxas)), default=0)
    dyn = {}
    for dd in (4, 8, 16, 20, 40, 64, 128, 396):
        nc4 = strip_channels(dd)
        R = _long_rows(256, nc4)
        warps, stage_b = _long_config(R, nc4, 256)
        dyn[f"d={dd}"] = (f"{_long_smem(256, nc4, R, warps, stage_b)} bytes, {warps} warps, B "
                          f"{'staged' if stage_b else 'cached'}")
    return f"ptxas static {static} bytes; dynamic at blocks of 256 frames {json.dumps(dyn)}"


def phase28_config():
    """Phase 28's discovery config: units up to 8192 frames, unbanded, PCA,
    alignments and images off."""
    from audio_pattern_discovery_tpu_torch.config import PipelineConfig

    return PipelineConfig().override({
        "segmentation.max_len_frames": 8192, "dtw.max_seq_len": 8192, "dtw.band": None,
        "autoencoder.method": "pca", "output.write_images": False,
        "output.write_alignments": False,
    })


def long_units_corpus_28(tmp: Path) -> tuple[Path, list]:
    """24 clips of 120 s at 44.1 kHz with 3 motifs of 25-45 s, 2 a clip
    (segments of ~4,300-7,750 frames; made once)."""
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    corpus = tmp / "long_units_28"
    truth = make_corpus(corpus, n_clips=24, n_motifs=3, occurrences_per_clip=2,
                        clip_seconds=120.0, motif_seconds=(25.0, 45.0), sample_rate=44_100,
                        seed=28)
    return corpus, [vars(t) for t in truth]


def phase28(dev, tmp: Path, keep: dict) -> dict:
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_lane_diag_pairs
    from audio_pattern_discovery_tpu_torch.ops.dtw_long import dtw_long_batch, dtw_long_batch_ref
    from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as ps
    from audio_pattern_discovery_tpu_torch.pipeline import DTW_KERNELS, discover

    corpus, truth = long_units_corpus_28(tmp)
    cfg = phase28_config()
    for k in DTW_KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    res = discover(corpus, cfg, out_dir=tmp / "long_units_28_out", device=dev)
    wall = time.perf_counter() - t0
    launched = {k.__name__: k.launches for k in DTW_KERNELS if k.launches}
    if set(launched) != {"dtw_long_batch"}:
        fail(f"phase 28: discover() launched {launched}; want dtw_long_batch alone")
    D, f, n = res.distance_matrix, res.seg_features, res.seg_lengths
    keep["features"] = (f, n)
    if not np.isfinite(D).all() or len(res.clusters) < 1:
        fail("phase 28: non-finite distances or no clusters")
    if int(n.min()) <= 4096:
        fail(f"phase 28: segments of {int(n.min())}-{int(n.max())} frames; want all past 4096")
    purity = manifest_purity(res.manifest(), truth)
    # 8 distances against the twin on the card (S=8192, block 256: the
    # route's blocks, whatever the bucket).
    rng = np.random.default_rng(28)
    ia = rng.integers(0, len(n), 8)
    ib = (ia + rng.integers(1, len(n), 8)) % len(n)
    fd = torch.from_numpy(f).to(dev)
    nd = torch.from_numpy(n.astype(np.int32)).to(dev)
    want = dtw_long_batch_ref(fd[ia], fd[ib], nd[ia], nd[ib], normalize="path_len")
    got = torch.from_numpy(D[ia, ib]).to(dev)
    k8_reading("phase 28 (8 distances vs the twin)", got, want)
    err8 = agree("phase 28 (8 distances vs the twin)", got, want, K8_RTOL,
                 K8_ATOL)
    t = {k: round(v, 3) for k, v in res.counters.timings_s.items()}
    log(f"phase 28: long units past 4096 frames ({len(n)} segments of {int(n.min())}-"
        f"{int(n.max())} frames, d={f.shape[2]}, {len(res.clusters)} clusters, planted-truth "
        f"purity {purity:.4f}): K8 launches {launched['dtw_long_batch']} and no other DTW "
        f"kernel; 8 distances match the twin (max abs err {err8:.3g}, relative "
        f"{K8_READINGS['phase 28 (8 distances vs the twin)']:.3g}); discover() wall "
        f"{wall:.2f} s (alignments off); stages {t}")
    # The job's DTW again through the scheduler: the same D bit for bit, the
    # same launches, and the split of its wall (K8's device time, host).
    _, split_launches = per_pair_split(dev, "unbanded", f, n, cfg.dtw, want=D)
    if split_launches != launched["dtw_long_batch"]:
        fail(f"phase 28: discover() launched K8 {launched['dtw_long_batch']} times, the same job "
             f"through the scheduler {split_launches}")
    # Widen band 16 on the same features: per pair (no tiled route past
    # 4096 frames), on K8.
    cfg_w = DTWConfig(band=16, band_mode="widen", max_seq_len=8192)
    if ps.route_for(f.shape[1], cfg_w) != "per_pair":
        fail("phase 28: route_for does not send a widen job of 8192 frames per pair")
    n0 = dtw_long_batch.launches
    D_w, _ = per_pair_split(dev, "widen band 16", f, n, cfg_w)
    if dtw_long_batch.launches == n0 or not np.isfinite(D_w).all():
        fail("phase 28: the widen job did not launch K8 or gave non-finite distances")
    agree("phase 28 (widen, 4 distances vs the twin)", torch.from_numpy(D_w[ia[:4], ib[:4]]).to(dev),
          dtw_long_batch_ref(fd[ia[:4]], fd[ib[:4]], nd[ia[:4]], nd[ib[:4]], band=16,
                             normalize="path_len"), K8_RTOL, K8_ATOL)
    # Diag band 16: the tiled route (K1, at the widest tile whose classes it
    # takes) and per pair (K8).
    cfg_d = DTWConfig(band=16, band_mode="diag", max_seq_len=8192)
    if ps.route_for(f.shape[1], cfg_d) != "diag":
        fail("phase 28: route_for does not keep a diag job of 8192 frames on K1")
    st_k1: dict = {}
    n1 = dtw_tile_lane_diag_pairs.launches
    t0 = time.perf_counter()
    D_k1 = ps.all_pairs_distances(f, n, cfg_d, device=dev, stats=st_k1)
    k1_wall = time.perf_counter() - t0
    if dtw_tile_lane_diag_pairs.launches == n1:
        fail("phase 28: the diag job did not launch K1")
    D_k8, _ = per_pair_split(dev, "diag band 16", f, n, cfg_d)
    diff = np.abs(D_k1 - D_k8)
    if not (np.isfinite(D_k8).all() and np.array_equal(D_k1, D_k8)):
        fail(f"phase 28: diag D on K1 (ti={st_k1['ti']}) and on K8 differ (max abs "
             f"{np.nanmax(diff)})")
    log(f"phase 28: diag band 16: K1 takes the job at ti={st_k1['ti']} ({st_k1['blocks']} "
        f"launches, {st_k1['kernel_s']:.4f} s of device time, wall {k1_wall:.3f} s); D on K1 and "
        f"on K8 bitwise equal")
    # The per-pair route on 64 sequences of 1,100-4,096 frames, unbanded
    # (K8 for every bucket: K6 ends at 1024), against the tiled K3 D.
    fj, nj = sorted_corpus(64, 4096, 16, 1100, 4096, seed=28, dev=dev)
    nj_np = nj.cpu().numpy()
    cfg_u = DTWConfig(band=None, normalize="path_len")
    t0 = time.perf_counter()
    D_k3 = ps.all_pairs_distances(fj, nj_np, cfg_u, device=dev)
    k3_wall = time.perf_counter() - t0
    D_pp, _ = per_pair_split(dev, "64 sequences of 1,100-4,096 frames, unbanded", fj, nj_np,
                             cfg_u)
    err = agree("phase 28 (per-pair K8 vs tiled K3)", torch.from_numpy(D_pp),
                torch.from_numpy(D_k3), K3_RTOL, K3_ATOL)
    log(f"phase 28: the per-pair route at 1,100-4,096 frames against the tiled K3 D (wall "
        f"{k3_wall:.3f} s): max abs difference {err:.3g} (rtol {K3_RTOL}, atol {K3_ATOL})")
    return {"launches": launched["dtw_long_batch"]}


def phase29(dev, tmp: Path) -> None:
    """A diag job of mixed lengths through ``discover()``: units of 2-40 s
    (a few hundred to ~6,900 frames), so tiles of 128 hold classes too wide
    for K1 and the scheduler halves the tile until K1 takes them; only K1
    launches."""
    from audio_pattern_discovery_tpu_torch.config import PipelineConfig
    from audio_pattern_discovery_tpu_torch.ops.dtw_long import dtw_long_batch_ref, long_block_shape
    from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as ps
    from audio_pattern_discovery_tpu_torch.pipeline import DTW_KERNELS, discover
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    corpus = tmp / "mixed_diag_29"
    truth = [vars(t) for t in make_corpus(
        corpus, n_clips=16, n_motifs=3, occurrences_per_clip=2, clip_seconds=90.0,
        motif_seconds=(2.0, 40.0), sample_rate=44_100, seed=29)]
    cfg = PipelineConfig().override({
        "segmentation.max_len_frames": 8192, "dtw.max_seq_len": 8192, "dtw.band": 16,
        "dtw.band_mode": "diag", "autoencoder.method": "pca", "output.write_images": False,
        "output.write_alignments": False,
    })
    for k in DTW_KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    res = discover(corpus, cfg, out_dir=tmp / "mixed_diag_29_out", device=dev)
    wall = time.perf_counter() - t0
    launched = {k.__name__: k.launches for k in DTW_KERNELS if k.launches}
    if set(launched) != {"dtw_tile_lane_diag_pairs"}:
        fail(f"phase 29: discover() launched {launched}; want dtw_tile_lane_diag_pairs alone")
    D, f, n = res.distance_matrix, res.seg_features, res.seg_lengths
    if not np.isfinite(D).all() or len(res.clusters) < 1:
        fail("phase 29: non-finite distances or no clusters")
    if not (int(n.min()) <= 1024 and int(n.max()) > 4096):
        fail(f"phase 29: segments of {int(n.min())}-{int(n.max())} frames; want a mix of units "
             "up to 1024 and past 4096 frames")
    # The job's DTW again through the scheduler: the same D bit for bit,
    # and the tile size it took.
    st: dict = {}
    if not np.array_equal(ps.all_pairs_distances(f, n, cfg.dtw, device=dev, stats=st), D):
        fail("phase 29: the diag job's D through the scheduler differs from discover()'s")
    # 8 distances against K8's twin (K1 and K8 agree bit for bit in phase 28).
    rng = np.random.default_rng(29)
    ia = rng.integers(0, len(n), 8)
    ib = (ia + rng.integers(1, len(n), 8)) % len(n)
    S8 = long_block_shape(int(max(n[ia].max(), n[ib].max())))[1]
    fd = torch.zeros((len(n), S8, f.shape[2]), device=dev)
    fd[:, : min(S8, f.shape[1])] = torch.from_numpy(f[:, :S8]).to(dev)
    nd = torch.from_numpy(n.astype(np.int32)).to(dev)
    want = dtw_long_batch_ref(fd[ia], fd[ib], nd[ia], nd[ib], band=16, band_mode="diag",
                              normalize="path_len")
    got = torch.from_numpy(D[ia, ib]).to(dev)
    tag = "phase 29 (8 distances vs K8's twin)"
    k8_reading(tag, got, want)
    err = agree(tag, got, want, K8_RTOL, K8_ATOL)
    log(f"phase 29: mixed-length diag band 16 through discover() ({len(n)} segments of "
        f"{int(n.min())}-{int(n.max())} frames, {int((n <= 1024).sum())} up to 1024 and "
        f"{int((n > 4096).sum())} past 4096, {len(res.clusters)} clusters, planted-truth purity "
        f"{manifest_purity(res.manifest(), truth):.4f}): K1 alone launches "
        f"({launched['dtw_tile_lane_diag_pairs']} launches) at ti={st['ti']} (the card's default "
        f"{ps.DEFAULT_TI['cuda']}), {st['kernel_s']:.4f} s of device time; 8 distances match "
        f"K8's twin (max abs err {err:.3g}, relative "
        f"{K8_READINGS[tag]:.3g}); discover() wall "
        f"{wall:.2f} s")


# The device probes of utils/doctor.py that phases 25 and 30 print.
DOCTOR_PROBES = ("name_power_limit", "dispatch_floor_ms", "hbm_gbps", "upload_mb_s")


def phase30(dev, tmp: Path) -> None:
    """Runtime extras on the card: ``--doctor`` (its device probes, and
    every kernel library current in ``compile_cache`` after phase 1's
    build); the seed-7 CLI at the golden config (band 16: K1) with
    ``--trace DIR``, whose trace must hold a CUDA kernel event of K1's for
    each of the run's K1 launches; ``time_fn`` (host wall to the
    synchronization) beside ``cuda_ms`` (device time) on one K1 call."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_lane_diag_pairs
    from audio_pattern_discovery_tpu_torch.utils.timer import time_fn

    proc = subprocess.run([sys.executable, "-m", "audio_pattern_discovery_tpu_torch", "--doctor"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"phase 30: --doctor exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    rep = json.loads(proc.stdout)
    probes, cache = rep["device"], rep["compile_cache"]
    if set(rep) != {"versions", "host", "native_lib", "compile_cache", "env", "device"}:
        fail(f"phase 30: --doctor's report has the keys {sorted(rep)}")
    if "error" in probes or probes["platform"] != "gpu" or not all(
            isinstance(probes[k], (int, float)) and probes[k] > 0 for k in DOCTOR_PROBES[1:]):
        fail(f"phase 30: --doctor's device probes: {probes}")
    if not isinstance(probes["name_power_limit"], str) or not probes["name_power_limit"]:
        fail(f"phase 30: --doctor read no name and power limit: {probes['name_power_limit']}")
    libs = cache["libraries"]
    if sorted(libs) != sorted(KERNELS) or set(libs.values()) != {"current"} or "error" in cache[
            "nvcc"]:
        fail(f"phase 30: --doctor's compile cache: {cache}")
    log(f"phase 30: --doctor: {json.dumps(probes)}; nvcc {cache['nvcc']['version']}; "
        f"{len(libs)} kernel libraries current in {cache['entries']} build entries "
        f"({cache['bytes']} bytes); native {json.dumps(rep['native_lib'])}")
    # --trace: K1's kernel events in the trace, one per launch of the run.
    cfg_path = tmp / "golden_cfg.json"
    golden_config().to_json(cfg_path)
    trace_dir = tmp / "trace_30"
    summary, wall, _ = cli("phase 30 (--trace)", seed7_corpus(tmp), tmp / "trace_30_out",
                           "-c", str(cfg_path), "--trace", str(trace_dir))
    launches = int(summary["counts"].get("launches.dtw_tile_lane_diag_pairs", 0))
    traces = list(trace_dir.glob("*.json"))
    if len(traces) != 1 or launches < 1:
        fail(f"phase 30: --trace wrote {traces} for a run of {launches} K1 launches")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1_events = [e for e in kernels if "lane_diag_kernel" in e.get("name", "")]
    if len(k1_events) != launches:
        fail(f"phase 30: the trace holds {len(k1_events)} events of K1's kernel "
             f"({len(kernels)} kernel events) for {launches} launches")
    k1_us = sum(float(e.get("dur", 0.0)) for e in k1_events)
    log(f"phase 30: --trace of the seed-7 CLI (wall {wall:.2f} s): {traces[0].name}, "
        f"{traces[0].stat().st_size} bytes, {len(events)} events, {len(kernels)} CUDA kernel "
        f"events, {len(k1_events)} of K1's ({k1_events[0]['name'][:60]}...) for {launches} "
        f"launches, {k1_us / 1e3:.3f} ms of K1 on the trace")
    # time_fn and cuda_ms on one K1 call at phase 2's shape.
    (feats, lens, rep_t, ii, jj), kw = k1_inputs(dev, 4, 16, seed=1)
    n0 = dtw_tile_lane_diag_pairs.launches
    wall_s = time_fn(lambda: dtw_tile_lane_diag_pairs(feats, lens, rep_t, ii, jj, **kw),
                     warmup=2, iters=11)
    dev_ms = cuda_ms(lambda: dtw_tile_lane_diag_pairs(feats, lens, rep_t, ii, jj, **kw), 20)
    if dtw_tile_lane_diag_pairs.launches - n0 != 13 + 21:
        fail("phase 30: time_fn and cuda_ms did not launch K1 once a call")
    if not wall_s * 1e3 >= dev_ms > 0:
        fail(f"phase 30: time_fn's wall {wall_s * 1e3:.3f} ms below cuda_ms's {dev_ms:.3f} ms")
    log(f"phase 30: one K1 call (10 tile-pairs, config-4 shape): time_fn {wall_s * 1e3:.3f} ms "
        f"(median host wall to the synchronization), cuda_ms {dev_ms:.3f} ms (device)")


# K8's Gram instantiation against its twin: both take the same rounded
# frames, so every product is exact and a cell differs only in the order
# of its fp32 sums (the d-term dot product, the squared norms), amplified
# by the cancellation in |a|^2 + |b|^2 - 2 a.b (tests/test_torch_bf16.py
# derives the bound, d 2^-24 (|a|^2 + |b|^2) relative to the squared cost:
# ~4e-6 a cell at d=16 on unit-variance frames, half that after the sqrt),
# and the errors cancel along a path.  The largest reading over phase 31 on
# the H100 80GB HBM3 at 700 W was 1.16e-7 relative (most checks bitwise);
# the limit is K8_RTOL's, over 10x that.
K8_BF16_RTOL = K8_RTOL
K8_BF16_ATOL = K8_ATOL


# bf16 products with fp32 sums on the tensor cores, dense (the H100 SXM's
# published peak at 700 W).
BF16_TC_OPS_S = 989e12


def cell_ops_gram(d: int) -> tuple[int, int]:
    """(fp32 operations outside the tensor cores, bf16 tensor-core
    operations) of one Euclidean DP cell of K8's Gram instantiation: the
    dot product's d products and d sums of bf16 operands in fp32 are
    tensor-core work; |a|^2 + |b|^2, the FMA |a|^2 + |b|^2 - 2 a.b, the max
    with 0, a sqrt, two mins and an add are not."""
    return 7, 2 * d


def bound_gram(cells: float, d: int, nbytes: float) -> tuple[float, str]:
    """``bound`` for K8's Gram instantiation: each kind of operation at its
    own peak rate."""
    fp32_ops, tc_ops = cell_ops_gram(d)
    t_ops = cells * (fp32_ops / FP32_OPS_S + tc_ops / BF16_TC_OPS_S)
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bf16_pair_bound(a: np.ndarray, b: np.ndarray, metric: str, band, band_mode: str,
                    normalize: str, want: float) -> float:
    """How far two bf16 Gram DTW runs on the same frames a [la, d] and
    b [lb, d] may differ (tests/test_torch_bf16.py derives it): both round
    the same fp32 operands to bf16, so every product is exact and a cell's
    cost differs only by the order of its fp32 sums (eps per squared cost,
    amplified by the sqrt near 0); a distance by the largest sum of that
    over a monotone path through the band (a max-plus DTW), plus each
    side's fp32 rounding of the path's sum."""
    U = 2.0 ** -24
    la, lb, d = len(a), len(b), a.shape[1]
    if metric == "cosine":
        a = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
        b = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-12)
    ar = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).double().numpy()
    br = torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(torch.bfloat16).double().numpy()
    absdot = np.abs(ar) @ np.abs(br).T
    if metric == "cosine":
        e = 2 * (d - 1) * U * absdot + 2 * U
    else:
        na = np.sum(a.astype(np.float64) ** 2, axis=1)[:, None]
        nb = np.sum(b.astype(np.float64) ** 2, axis=1)[None, :]
        e = 2 * (d + 2) * U * (na + nb + 2 * absdot)
        if metric == "euclidean":
            sq = np.maximum(na + nb - 2 * ar @ br.T, 0.0)
            e = 2 * e / np.sqrt(np.maximum(sq, e)) + 2 * U * np.sqrt(sq)
    i, j = np.arange(la)[:, None], np.arange(lb)[None, :]
    if band is None:
        valid = np.ones((la, lb), bool)
    elif band_mode == "diag":
        valid = np.abs(j * (la - 1) - i * (lb - 1)) <= max(band, 1) * max(la - 1, lb - 1)
    else:
        valid = np.abs(i - j) <= max(band, abs(la - lb))
    prev = np.full(lb + 1, -np.inf)          # prev[j + 1]: the row above; prev[0] the origin's
    prev[0] = 0.0
    for r in range(la):
        cols = np.nonzero(valid[r])[0]
        cur = np.full(lb + 1, -np.inf)
        if len(cols):
            lo, hi = cols[0], cols[-1]
            up = np.maximum(prev[lo:hi + 1], prev[lo + 1:hi + 2])
            run = np.cumsum(e[r, lo:hi + 1])
            cur[lo + 1:hi + 2] = run + np.maximum.accumulate(up - np.concatenate([[0.0], run[:-1]]))
        prev = cur
        prev[0] = -np.inf
    tol = float(prev[lb])
    if normalize == "path_len":
        tol /= la + lb
    return tol + 2 * (la + lb) * U * abs(want)


def k8_bf16_check(tag: str, args, **kw) -> tuple[float, float]:
    """K8's Gram instantiation against its twin on the card: the max abs
    error and the twin's ms."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_long import dtw_long_batch, dtw_long_batch_ref

    n0 = dtw_long_batch.launches
    got = dtw_long_batch(*args, matmul_dtype="bfloat16", **kw)
    torch.cuda.synchronize()
    if dtw_long_batch.launches == n0:
        fail(f"{tag}: K8's Gram instantiation did not launch")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    want = dtw_long_batch_ref(*args, matmul_dtype="bfloat16", **kw)
    ev[1].record()
    torch.cuda.synchronize()
    k8_reading(tag, got, want)
    f32 = dtw_long_batch(*args, **kw)
    fin = torch.isfinite(f32)
    if bool(fin.any()) and bool((got[fin] == f32[fin]).all()):
        fail(f"{tag}: the Gram instantiation gave the fp32 distances")
    return agree(tag, got, want, K8_BF16_RTOL, K8_BF16_ATOL), ev[0].elapsed_time(ev[1])


def phase31(dev, tmp: Path, keep: dict) -> dict:
    """dtw.dtype=bfloat16 on the card: K8's Gram instantiation against its
    twin (64 pairs at S=8192 unbanded, widen 16 and diag 16 at d=16; d=64
    and cosine at S=2048), timed beside the fp32 instantiation at 512 pairs
    of bucket 8192; ``all_pairs_distances`` on phase 28's features with
    dtype bfloat16 (the main path of the Gram instantiation: its launches
    counted from 0), 8 pairs against the twin on the card and the 3 shortest
    segments' pairs against the CPU port; the seed-7 CLI with
    ``-s dtw.dtype=bfloat16 -s dtw.band=16`` (diag buckets of at most 1024
    frames: K8's Gram instantiation on the card) on the card and on the
    CPU, and that job again in this process."""
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.ops.dtw import dtw_batch
    from audio_pattern_discovery_tpu_torch.ops.dtw_long import dtw_long_batch, dtw_long_batch_ref
    from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as ps
    from audio_pattern_discovery_tpu_torch.pipeline import DTW_KERNELS, discover

    S, d = 8192, 16
    args = long_pairs(dev, 64, S, d, 4097, seed=31, near=32)
    errs, plain = {}, {}
    for mode, kw in (("unbanded", dict(band=None)), ("widen 16", dict(band=16)),
                     ("diag 16", dict(band=16, band_mode="diag"))):
        errs[mode], plain[mode] = k8_bf16_check(f"phase 31 (S={S}, {mode})", args, **kw)
    Sw = K8_SWEEP_S
    errs["d=64"], _ = k8_bf16_check("phase 31 (d=64)", long_pairs(dev, 8, Sw, 64, Sw // 2,
                                                                    seed=311))
    errs["cosine"], _ = k8_bf16_check("phase 31 (cosine)", long_pairs(dev, 8, Sw, d, Sw // 2,
                                                                       seed=312), metric="cosine")
    res = {"max_abs_err": max(errs.values()), "plain_ms": plain["unbanded"]}
    res["ms"] = cuda_ms(lambda: dtw_long_batch(*args, matmul_dtype="bfloat16"), 3)
    cells = float(pair_cells(args[2], args[3], "full").sum())
    nbytes = pair_bytes(args[2], args[3], d + 1)        # frames and their norms
    res["bound_ms"], res["bound_by"] = bound_gram(cells, d, nbytes)
    readings = {k: v for k, v in K8_READINGS.items() if k.startswith("phase 31")}
    log(f"phase 31: K8 (Gram) vs its twin: max abs err "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})} (rtol {K8_BF16_RTOL:.3g}, "
        f"atol {K8_BF16_ATOL}); largest relative difference per check (distances past 1): "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in readings.items()})}")
    log(f"phase 31: K8 (Gram) {res['ms']:.3f} ms/call on the 64 pairs ({cells:.4g} cells, "
        f"{rate_line(res['ms'], cells, res['bound_ms'])} at {cell_ops_gram(d)} (fp32, "
        f"bf16 tensor-core) ops a cell), "
        f"plain {res['plain_ms']:.3f} ms/call")
    del args
    # 512 pairs of bucket 8192 (phase 27's launch size), unbanded: the Gram
    # and the fp32 instantiations in turns.
    g = torch.Generator(device=dev).manual_seed(277)
    la = torch.randint(4097, S + 1, (512,), generator=g, device=dev, dtype=torch.int32)
    lb = torch.randint(S - 31, S + 1, (512,), generator=g, device=dev, dtype=torch.int32)
    big = (torch.randn((512, S, d), generator=g, device=dev),
           torch.randn((512, S, d), generator=g, device=dev), la, lb)
    times: dict[str, list[float]] = {"bf16": [], "fp32": []}
    for name in ("bf16", "fp32", "fp32", "bf16"):
        mm = "bfloat16" if name == "bf16" else None
        cuda_ms(lambda: dtw_long_batch(*big, matmul_dtype=mm), 3, per_call=times[name])
    c512 = float(pair_cells(la, lb, "full").sum())
    b16_ms, _ = bound_gram(c512, d, pair_bytes(la, lb, d + 1))
    f32_ms, _ = bound(c512, d, pair_bytes(la, lb, d))
    med = {k: sorted(t)[len(t) // 2] for k, t in times.items()}
    log(f"phase 31: 512 pairs of bucket {S} (unbanded, in turns): K8 Gram {spread(times['bf16'])}, "
        f"{b16_ms / med['bf16']:.1%} of its bound {b16_ms:.3f} ms; K8 fp32 "
        f"{spread(times['fp32'])}, {f32_ms / med['fp32']:.1%} of its bound {f32_ms:.3f} ms")
    del big
    # The main path: all_pairs_distances on phase 28's features, bfloat16.
    if "features" not in keep:
        res28 = discover(long_units_corpus_28(tmp)[0], phase28_config(),
                         out_dir=tmp / "long_units_31_out", device=dev)
        keep["features"] = (res28.seg_features, res28.seg_lengths)
    f, n = keep["features"]
    cfg = DTWConfig(band=None, max_seq_len=8192, dtype="bfloat16")
    for k in DTW_KERNELS:
        k.launches = 0
    st: dict = {}
    t0 = time.perf_counter()
    D = ps.all_pairs_distances(f, n, cfg, device=dev, stats=st)
    wall = time.perf_counter() - t0
    launched = {k.__name__: k.launches for k in DTW_KERNELS if k.launches}
    res["launches"] = dtw_long_batch.launches
    if st["route"] != "per_pair" or launched != {"dtw_long_batch": res["launches"]} or \
            res["launches"] < 1:
        fail(f"phase 31: the bf16 job took the route {st['route']} and launched {launched} "
             f"(Gram {res['launches']}); want K8's Gram instantiation alone")
    rng = np.random.default_rng(31)
    ia = rng.integers(0, len(n), 8)
    ib = (ia + rng.integers(1, len(n), 8)) % len(n)
    fd = torch.from_numpy(f).to(dev)
    nd = torch.from_numpy(n.astype(np.int32)).to(dev)
    tag = "phase 31 (8 distances vs the twin)"
    want = dtw_long_batch_ref(fd[ia], fd[ib], nd[ia], nd[ib], normalize="path_len",
                              matmul_dtype="bfloat16")
    got = torch.from_numpy(D[ia, ib]).to(dev)
    k8_reading(tag, got, want)
    err8 = agree(tag, got, want, K8_BF16_RTOL, K8_BF16_ATOL)
    short = np.argsort(n, kind="stable")[:3]
    t0 = time.perf_counter()
    D_cpu = ps.all_pairs_distances(f[short], n[short], cfg, device="cpu")
    cpu_wall = time.perf_counter() - t0
    tag_cpu = "phase 31 (3 pairs vs the CPU port)"
    k8_reading(tag_cpu, torch.from_numpy(D[np.ix_(short, short)]), torch.from_numpy(D_cpu))
    err_cpu = agree(tag_cpu, torch.from_numpy(D[np.ix_(short, short)]), torch.from_numpy(D_cpu),
                    K8_BF16_RTOL, K8_BF16_ATOL)
    D32 = ps.all_pairs_distances(f, n, DTWConfig(band=None, max_seq_len=8192), device=dev)
    off = ~np.eye(len(n), dtype=bool)
    log(f"phase 31: all_pairs_distances on phase 28's features ({len(n)} segments of "
        f"{int(n.min())}-{int(n.max())} frames), dtype bfloat16: route {st['route']}, K8 Gram "
        f"{res['launches']} launches in {st['long_calls']} merged calls, "
        f"{st['kernel_s_by'].get('dtw_long_batch', 0.0):.4f} s of device time, wall {wall:.3f} s; "
        f"8 distances vs the twin max abs err {err8:.3g} (relative {K8_READINGS[tag]:.3g}); the 3 "
        f"shortest segments' pairs vs the CPU port ({cpu_wall:.1f} s) {err_cpu:.3g} (relative "
        f"{K8_READINGS[tag_cpu]:.3g}); against the fp32 D: max relative difference "
        f"{float(np.max(np.abs(D - D32)[off] / D32[off])):.3g}")
    # The seed-7 CLI in bf16 with band 16: every bucket is a diag bucket of at
    # most 1024 frames, which K8's Gram instantiation takes on the card
    # (the plain dtw_batch on the CPU).  The card run's D is held to the
    # plain dtw_batch on the CPU on the card run's own features (same
    # inputs) at each pair's derived bound; the partition is held to a CPU
    # run of the CLI (its features differ from the card's in their last
    # bits, phase 9).
    golden_config().to_json(tmp / "golden_cfg.json")
    flags = ("-c", str(tmp / "golden_cfg.json"), "-s", "dtw.dtype=bfloat16", "-s", "dtw.band=16",
             "-s", "output.write_features=true")
    out = {}
    corpus = seed7_corpus(tmp)
    with ThreadPoolExecutor(2) as pool:      # the two processes run side by side
        runs = {devname: pool.submit(cli, f"phase 31 (CLI, {devname})", corpus,
                                     tmp / f"bf16_{devname}", *flags, "--device", devname)
                for devname in ("cuda", "cpu")}
    for devname, run in runs.items():
        summary, w, manifest = run.result()
        counts = summary["counts"]
        if int(counts["dtw_tile_programs"]) != 0:
            fail(f"phase 31: the bf16 CLI on {devname} ran tile-pair programs")
        launched = {k.__name__: int(counts.get(f"launches.{k.__name__}", 0)) for k in DTW_KERNELS}
        k8_only = {k: n for k, n in launched.items() if n} == (
            {"dtw_long_batch": launched["dtw_long_batch"]} if devname == "cuda" else {})
        if not k8_only or (devname == "cuda" and launched["dtw_long_batch"] < 1):
            fail(f"phase 31: the bf16 CLI on {devname} launched {launched}; want K8 alone on the "
                 "card, no kernel on the CPU")
        out[devname] = (np.load(tmp / f"bf16_{devname}" / "distance_matrix.npy"),
                        partition_of(manifest), w, launched["dtw_long_batch"])
    if out["cuda"][1] != out["cpu"][1]:
        fail("phase 31: the bf16 CLI's partition on the card differs from the CPU's")
    Dc = out["cuda"][0]
    with np.load(tmp / "bf16_cuda" / "features.npz") as z:
        f7, n7 = z["features"], z["lengths"].astype(np.int32)
    dcfg = golden_config().dtw
    kw7 = dict(metric=dcfg.metric, band=16, band_mode=dcfg.band_mode, normalize=dcfg.normalize)
    ii, jj = np.triu_indices(len(n7), 1)
    ref = np.concatenate([
        dtw_batch(torch.from_numpy(f7[ii[s:s + 512]]), torch.from_numpy(f7[jj[s:s + 512]]),
                  torch.from_numpy(n7[ii[s:s + 512]]), torch.from_numpy(n7[jj[s:s + 512]]),
                  matmul_dtype="bfloat16", **kw7).numpy() for s in range(0, len(ii), 512)])
    tol = np.array([bf16_pair_bound(f7[i, :n7[i]], f7[j, :n7[j]], dcfg.metric, 16,
                                    dcfg.band_mode, dcfg.normalize, r)
                    for i, j, r in zip(ii, jj, ref)])
    err7 = np.abs(Dc[ii, jj].astype(np.float64) - ref)
    if Dc.shape != (len(n7),) * 2 or not (err7 <= tol).all():
        worst = int(np.argmax(err7 - tol))
        fail(f"phase 31: the bf16 CLI's D on the card differs from the plain dtw_batch on the CPU "
             f"on its features by {err7[worst]:.3g} at pair ({ii[worst]}, {jj[worst]}), over "
             f"its bound {tol[worst]:.3g}")
    f32_7 = ps.all_pairs_distances(f7, n7, DTWConfig(band=16, band_mode=dcfg.band_mode,
                                                     normalize=dcfg.normalize), device=dev)
    if np.array_equal(Dc, f32_7):
        fail("phase 31: the bf16 CLI's D on the card is the fp32 D")
    # The same diag path in this process, its K8 launches counted from 0 and
    # timed: bitwise the CLI's D (same features, same kernel).
    for k in DTW_KERNELS:
        k.launches = 0
    st7: dict = {}
    t0 = time.perf_counter()
    D7 = ps.all_pairs_distances(f7, n7, DTWConfig(band=16, band_mode=dcfg.band_mode,
                                                  normalize=dcfg.normalize, dtype="bfloat16"),
                                device=dev, stats=st7)
    wall7 = time.perf_counter() - t0
    launched7 = {k.__name__: k.launches for k in DTW_KERNELS if k.launches}
    if launched7 != {"dtw_long_batch": launched7.get("dtw_long_batch", 0)} or not \
            np.array_equal(D7, Dc):
        fail(f"phase 31: the seed-7 diag job in this process launched {launched7}; its D "
             f"differs from the CLI's by {np.abs(D7 - Dc).max():.3g}")
    off = ~np.eye(len(n7), dtype=bool)
    log(f"phase 31: the seed-7 CLI with -s dtw.dtype=bfloat16 -s dtw.band=16 (the two processes "
        f"side by side): card {out['cuda'][2]:.2f} s ({out['cuda'][3]} K8 Gram launches), CPU "
        f"{out['cpu'][2]:.2f} s, partition exact, dtw_tile_programs 0; the card's D vs the plain "
        f"dtw_batch on the CPU on the card's features ({len(ii)} pairs of {int(n7.min())}-"
        f"{int(n7.max())} frames, d={f7.shape[2]}): max abs {err7.max():.3g}, at most "
        f"{float((err7 / tol).max()):.3g} of each pair's bound (largest bound "
        f"{tol.max():.3g}); vs the fp32 D max relative "
        f"{float(np.max(np.abs(Dc - f32_7)[off] / f32_7[off])):.3g}; in this process "
        f"all_pairs_distances: {launched7['dtw_long_batch']} K8 Gram launches in "
        f"{st7['long_calls']} merged calls, {st7['kernel_s_by']['dtw_long_batch'] * 1e3:.3f} ms "
        f"of device time, wall {wall7 * 1e3:.1f} ms, D bitwise the CLI's")
    return res


def per_pair_split(dev, tag: str, f, n, cfg, want=None) -> tuple[np.ndarray, int]:
    """The per-pair route (``all_pairs_distances(tiled=False)``) on a job of
    K8's buckets: its D (bit for bit ``want`` where given) and K8's
    launches, and its wall beside the split: blocks, merged K8 calls, K8's
    launches (at most max(nBa + nBb - 1) over the job's pairs a merged call,
    else it fails) and device time, the gathers, the host's dispatch,
    collect and scatter."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_long import dtw_long_batch
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances

    n0 = dtw_long_batch.launches
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D = all_pairs_distances(f, n, cfg, device=dev, stats=stats, tiled=False)
    wall = time.perf_counter() - t0
    if want is not None and not np.array_equal(D, want):
        fail(f"phase 28: the {tag} job's D through the scheduler differs from discover()'s")
    launches = dtw_long_batch.launches - n0
    nb = -(-np.sort(np.asarray(n).astype(np.int64))[::-1] // 256)
    per_call = int(nb[0] + nb[1] - 1)
    if launches > per_call * stats["long_calls"]:
        fail(f"phase 28: the {tag} job launched K8 {launches} times in {stats['long_calls']} "
             f"merged calls; at most {per_call} a call")
    by = stats["kernel_s_by"]
    log(f"phase 28: per-pair route, {tag}: {stats['pairs']} pairs, wall {wall:.3f} s; "
        f"{stats['blocks']} blocks in {stats['long_calls']} merged K8 calls, K8 {launches} "
        f"launches (at most {per_call} a call) and "
        f"{by.get('dtw_long_batch', 0.0):.4f} s of device time, other kernels "
        f"{json.dumps({k: round(v, 4) for k, v in by.items() if k != 'dtw_long_batch'})}, "
        f"gathers {stats['gather_s']:.4f} s; host: dispatch {stats['dispatch_s']:.4f} s, "
        f"collect {stats['collect_s']:.4f} s, scatter {stats['scatter_s']:.4f} s, enumerate "
        f"{stats['enumerate_s']:.4f} s")
    return D, launches


# The K4/K5 gate: class stripes (W = 2*wv+2 slots) and padded lengths at
# which --crossover times both kernels on one job.
CROSSOVER = ((128, 34), (128, 66), (128, 98), (128, 130), (128, 144), (256, 130), (256, 258),
             (512, 258), (512, 322), (512, 386), (512, 450), (512, 514), (1024, 386),
             (1024, 514), (1024, 1026))


def crossover(dev) -> None:
    """K4 and K5 on the same job per class stripe W: length-sorted tiles of
    lengths S-wv..S (every pair inside the class bound; 4 tiles, all 10
    tile-pairs, up to S=256, else 2 tiles and 3), d=16, band 16, each kernel
    with its layout built once; in turns K4, K5, K5, K4.  Sets
    pair_scheduler.LANE_MAX_W."""
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
        dtw_tile_lane_pairs,
        dtw_tile_stripe_pairs,
        frame_layout,
        strip_layout,
    )

    for S, W in CROSSOVER:
        wv = (W - 2) // 2
        nT, reps = (4, 10) if S <= 256 else (2, 2)
        (feats, lens, ii, jj), kw = widen_inputs(dev, nT, S, 16, S - wv, seed=S + W)
        kw["wv_max"] = wv
        f4, f5 = strip_layout(feats, kw["ti"]), frame_layout(feats)
        agree(f"crossover W={W}", dtw_tile_stripe_pairs(feats, lens, ii, jj, frames=f5, **kw),
              dtw_tile_lane_pairs(feats, lens, ii, jj, frames=f4, **kw), K5_RTOL, K5_ATOL)
        runs = {"K4": lambda: dtw_tile_lane_pairs(feats, lens, ii, jj, frames=f4, **kw),
                "K5": lambda: dtw_tile_stripe_pairs(feats, lens, ii, jj, frames=f5, **kw)}
        t = [(name, cuda_ms(runs[name], reps)) for name in ("K4", "K5", "K5", "K4")]
        k4_ms = (t[0][1] + t[3][1]) / 2
        k5_ms = (t[1][1] + t[2][1]) / 2
        log(f"crossover: S={S} W={W} (lengths {S - wv}-{S}, {len(ii)} tile-pairs): K4 "
            f"{t[0][1]:.3f} / {t[3][1]:.3f} ms, K5 {t[1][1]:.3f} / {t[2][1]:.3f} ms; "
            f"K4/K5 {k4_ms / k5_ms:.2f}")


# Run in a subprocess with one checkout's package first on sys.path: K4 and
# K1 on phase 12's tiles, K4 on the whole config-4 widen job (K4 forced), K6
# on pairs of that job's corpus (indices from the file argv[3]), K3 at phase
# 7's shape and K7 at phase 16's; the times of K4 and K5 at phase 12's shape
# (a config-4 wide class), of K6, of K3 and of K7.
_AGAINST = r"""
import inspect, json, sys, time
from pathlib import Path
import numpy as np, torch
tree, out = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
from audio_pattern_discovery_tpu_torch.config import DTWConfig
from audio_pattern_discovery_tpu_torch.ops import dtw_cuda as tk
from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances_tiled
assert tk.__file__.startswith(tree), tk.__file__
dev = torch.device("cuda", 0)

def corpus(K, S, d, lo, hi, seed, sort):
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(lo, hi + 1, (K,), generator=g, device=dev, dtype=torch.int32)
    if sort:
        lens, _ = torch.sort(lens)
    feats = torch.randn((K, S, d), generator=g, device=dev)
    feats *= (torch.arange(S, device=dev)[None, :, None] < lens[:, None, None])
    return feats.contiguous(), lens.contiguous()

def ms(fn, reps=20):
    # The device sleeps while the host queues the calls (as cuda_ms).
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

def prebuilt(fn, build):
    return {"frames": build()} if "frames" in inspect.signature(fn).parameters else {}

feats, lens = corpus(512, 128, 16, 64, 128, 12, True)
pairs = [(i, j) for i in range(4) for j in range(i, 4)]
ii = torch.tensor([p[0] for p in pairs], dtype=torch.int32, device=dev)
jj = torch.tensor([p[1] for p in pairs], dtype=torch.int32, device=dev)
kw = dict(ti=128, band=16, wv_max=64, rows=128)
f4 = prebuilt(tk.dtw_tile_lane_pairs, lambda: tk.strip_layout(feats, 128))
f5 = prebuilt(tk.dtw_tile_stripe_pairs, lambda: tk.frame_layout(feats))
k4 = tk.dtw_tile_lane_pairs(feats, lens, ii, jj, **kw, **f4).cpu().numpy()
# K1 on the same tiles, long side on rows, at the class contract.
l_np = lens.cpu().numpy()
rep = torch.from_numpy(tk.tile_rep_lengths(l_np, 4, 128, 512)).to(dev)
t_lo = [int(l_np[t * 128:(t + 1) * 128].min()) for t in range(4)]
t_hi = [int(l_np[t * 128:(t + 1) * 128].max()) for t in range(4)]
wv1 = max(tk.diag_class_bounds(16, t_lo[j], t_hi[j], t_lo[i], t_hi[i])[0] for i, j in pairs)
f1 = prebuilt(tk.dtw_tile_lane_diag_pairs, lambda: tk.strip_layout(feats, 128))
k1 = tk.dtw_tile_lane_diag_pairs(feats, lens, rep, jj, ii, ti=128, band=16, wv_max=wv1,
                                 rows=128, **f1).cpu().numpy()
res = {"k4_ms": ms(lambda: tk.dtw_tile_lane_pairs(feats, lens, ii, jj, **kw, **f4)),
       "k5_ms": ms(lambda: tk.dtw_tile_stripe_pairs(feats, lens, ii, jj, **kw, **f5))}
f4k, l4k = corpus(10240, 128, 16, 64, 128, 4, False)
cfg = DTWConfig(band=16, band_mode="widen", normalize="path_len")
D = all_pairs_distances_tiled(f4k, l4k.cpu().numpy(), cfg, device=dev, lane=True)
# K6 (widen band 16) on pairs of the same corpus, the caller's indices:
# phase 16's 4,096 pairs and 131,072 in the per-pair route's order.
idx, k6 = np.load(sys.argv[3]), {}
for n in (4096, 131072):
    ia, ib = (torch.from_numpy(idx[f"{s}{n}"]).to(dev) for s in ("ia", "ib"))
    args6 = (f4k[ia], f4k[ib], l4k[ia], l4k[ib])
    k6[f"k6_{n}"] = tk.dtw_batch_pallas(*args6, band=16).cpu().numpy()
    res[f"k6_{n}_ms"] = ms(lambda: tk.dtw_batch_pallas(*args6, band=16))
    del args6
del f4k
# K3 at phase 7's shape (S=1024, lengths 257-1024, 3 tile-pairs).
f3, l3 = corpus(256, 1024, 16, 257, 1024, 7, True)
i3 = torch.tensor([0, 0, 1], dtype=torch.int32, device=dev)
j3 = torch.tensor([0, 1, 1], dtype=torch.int32, device=dev)
kw3 = dict(ti=128, width=int(l3.max()), rows=int(l3.max()))
f3k = prebuilt(tk.dtw_tile_lane_full_pairs, lambda: tk.frame_layout(f3))
k3 = tk.dtw_tile_lane_full_pairs(f3, l3, i3, j3, **kw3, **f3k).cpu().numpy()
res["k3_ms"] = ms(lambda: tk.dtw_tile_lane_full_pairs(f3, l3, i3, j3, **kw3, **f3k), 3)
# K7 at phase 16's shape (512 gathered pairs of 900-1024 frames, S=1024).
g = torch.Generator(device=dev).manual_seed(16)
la7 = torch.randint(900, 961, (512,), generator=g, device=dev, dtype=torch.int32)
lb7 = la7 + torch.randint(0, 64, (512,), generator=g, device=dev, dtype=torch.int32)
a7 = torch.randn((512, 1024, 16), generator=g, device=dev)
b7 = torch.randn((512, 1024, 16), generator=g, device=dev)
k7 = tk._dtw_batch_stripe(a7, b7, la7, lb7, band=16, max_len_diff=63).cpu().numpy()
res["k7_ms"] = ms(lambda: tk._dtw_batch_stripe(a7, b7, la7, lb7, band=16, max_len_diff=63), 5)
# K8 where the tree has it: 64 pairs at S=2048 (lengths 1025-2048), unbanded.
k8 = {}
if (Path(tree) / "audio_pattern_discovery_tpu_torch" / "ops" / "dtw_long.py").exists():
    from audio_pattern_discovery_tpu_torch.ops.dtw_long import dtw_long_batch
    la8 = torch.randint(1025, 2049, (64,), generator=g, device=dev, dtype=torch.int32)
    lb8 = torch.randint(1025, 2049, (64,), generator=g, device=dev, dtype=torch.int32)
    a8 = torch.randn((64, 2048, 16), generator=g, device=dev)
    b8 = torch.randn((64, 2048, 16), generator=g, device=dev)
    k8["k8"] = dtw_long_batch(a8, b8, la8, lb8).cpu().numpy()
    res["k8_ms"] = ms(lambda: dtw_long_batch(a8, b8, la8, lb8), 3)
    # Wider frames on the same lengths: d=64 and d=128.
    for dd in (64, 128):
        aw = torch.randn((64, 2048, dd), generator=g, device=dev)
        bw = torch.randn((64, 2048, dd), generator=g, device=dev)
        k8[f"k8_d{dd}"] = dtw_long_batch(aw, bw, la8, lb8).cpu().numpy()
        res[f"k8_d{dd}_ms"] = ms(lambda: dtw_long_batch(aw, bw, la8, lb8), 3)
    # Phase 28's unbanded job through the per-pair route (the caller's
    # features): its D, wall and K8 device time.
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances
    job = np.load(sys.argv[4])
    cfg28 = DTWConfig(**json.loads(sys.argv[5]))
    st = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k8["d28"] = all_pairs_distances(job["f"], job["n"], cfg28, device=dev, stats=st, tiled=False)
    res["d28_wall_s"] = time.perf_counter() - t0
    res["d28_k8_s"] = st["kernel_s_by"].get("dtw_long_batch", 0.0)
np.savez(out, k1=k1, k4=k4, D=D, k3=k3, k7=k7, **k6, **k8)
print(json.dumps(res))
"""


def against(other: Path) -> None:
    """K1, K3-K8 of this checkout against another's (its parent), each run
    in its own process in turns other, this, this, other: K5's and K4's
    times at a config-4 wide class, K6's at phase 16's 4,096 pairs and at
    131,072 in the per-pair route's order (widen band 16), K3's at phase 7's
    shape, K7's at phase 16's and K8's at 64 pairs of S=2048 where the
    checkout has it; outputs bitwise: K1's on phase 12's tiles (diag band
    16), K4's on phase 12's tile-pairs and as the config-4 widen D with K4
    forced, K3's on phase 7's tile-pairs, K6's, K7's on phase 16's pairs,
    and K8's across the runs that have it, at 64 pairs of S=2048 (d=16, 64
    and 128, each timed) and as phase 28's unbanded D through the per-pair
    route (phase 28's features from this checkout's front end), with that
    job's wall and K8 time."""
    if not (other / "audio_pattern_discovery_tpu_torch").is_dir():
        fail(f"--against {other}: no audio_pattern_discovery_tpu_torch there")
    dev = torch.device("cuda", 0)
    _, lens = config4_corpus(10_240, 128, 16, seed=4, dev=dev)
    ia, ib = k6_pairs(lens, torch.Generator(device=dev).manual_seed(16))
    ia_r, ib_r = route_pairs(lens, 131_072, seed=161)
    with tempfile.TemporaryDirectory(prefix="apd_against_") as tmp_dir:
        idx = Path(tmp_dir) / "k6_pairs.npz"
        np.savez(idx, **{k: v.cpu().numpy() for k, v in (
            ("ia4096", ia), ("ib4096", ib), ("ia131072", ia_r), ("ib131072", ib_r))})
        from dataclasses import asdict

        from audio_pattern_discovery_tpu_torch.pipeline import discover

        corpus, _ = long_units_corpus_28(Path(tmp_dir))
        cfg28 = phase28_config()
        res28 = discover(corpus, cfg28, out_dir=Path(tmp_dir) / "out28", device=dev)
        job28 = Path(tmp_dir) / "job28.npz"
        np.savez(job28, f=res28.seg_features, n=res28.seg_lengths)
        runs = []
        for n, tree in enumerate((other, REPO, REPO, other)):
            out = Path(tmp_dir) / f"run{n}.npz"
            proc = subprocess.run([sys.executable, "-c", _AGAINST, str(tree), str(out), str(idx),
                                   str(job28), json.dumps(asdict(cfg28.dtw))],
                                  cwd=tmp_dir, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                fail(f"--against: the run in {tree} exited {proc.returncode}:\n"
                     f"{proc.stderr[-3000:]}")
            runs.append((json.loads(proc.stdout.strip().splitlines()[-1]), np.load(out)))
        for key, name in (("k1", "K1"), ("k4", "K4"), ("D", "K4"), ("k3", "K3"), ("k7", "K7"),
                          ("k6_4096", "K6"), ("k6_131072", "K6")):
            if not all(np.array_equal(runs[0][1][key], r[1][key]) for r in runs[1:]):
                fail(f"--against: {name}'s {key} differs from the other checkout's")
        # K8 in the checkouts that have it: bitwise across their runs.
        k8_runs = [r for r in runs if "k8" in r[1]]
        for key in ("k8", "k8_d64", "k8_d128", "d28"):
            if not all(np.array_equal(k8_runs[0][1][key], r[1][key]) for r in k8_runs[1:]):
                fail(f"--against: K8's {key} differs between runs")
        log("against: K1 on phase 12's tiles (diag band 16), K4 on phase 12's tile-pairs, the "
            "config-4 widen D with K4 forced, K3 on phase 7's tile-pairs, K6 (widen band 16) at "
            "4,096 and 131,072 pairs and K7 on phase 16's pairs are bitwise equal to the other "
            f"checkout's; K8 is in {len(k8_runs)} of the 4 runs, bitwise equal across them (64 "
            f"pairs at S=2048 at d=16, 64 and 128, and phase 28's unbanded D of "
            f"{len(res28.seg_lengths)} segments)")
        shapes = {"k4_ms": "at a config-4 wide class (10 tile-pairs, S=128, W=130)",
                  "k5_ms": "at a config-4 wide class (10 tile-pairs, S=128, W=130)",
                  "k6_4096_ms": "at phase 16's 4,096 pairs (S=128, widen band 16)",
                  "k6_131072_ms": "at 131,072 pairs in the route's order",
                  "k3_ms": "at phase 7's shape (3 tile-pairs, S=1024)",
                  "k7_ms": "at phase 16's shape (512 pairs, S=1024, band 16, max_len_diff 63)"}
        shapes["k8_ms"] = "at 64 pairs of 1,025-2,048 frames (S=2048, unbanded)"
        for dd in (64, 128):
            shapes[f"k8_d{dd}_ms"] = f"at the same 64 pairs at d={dd}"
        for key, shape in shapes.items():
            got = [f"{r[0][key]:.3f}" if key in r[0] else "absent" for r in runs]
            log(f"against: {key[:2].upper()} {shape}: other {got[0]} / {got[3]} ms, this "
                f"{got[1]} / {got[2]} ms")
        for key, what in (("d28_wall_s", "wall"), ("d28_k8_s", "K8 device time")):
            got = [f"{r[0][key]:.4f}" if key in r[0] else "absent" for r in runs]
            log(f"against: phase 28's unbanded job per pair, {what}: other {got[0]} / {got[3]} s, "
                f"this {got[1]} / {got[2]} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default="",
                        help="comma-separated phase numbers to run (phase 1 always runs)")
    parser.add_argument("--crossover", action="store_true",
                        help="after phase 1, time K4 against K5 per class stripe and stop")
    parser.add_argument("--against", metavar="TREE",
                        help="after phase 1, compare K1, K3-K8 with those of another checkout "
                             "of the repo (in turns, bitwise for K1, K3, K4, K6 and K7) and stop")
    args = parser.parse_args()
    only = {int(p) for p in args.phases.split(",") if p}
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card only")
    dev = torch.device("cuda", 0)
    import audio_pattern_discovery_tpu_torch  # noqa: F401  (sets the TF32 flags)

    if args.crossover or args.against:
        phase1(dev)
        if args.crossover:
            crossover(dev)
        if args.against:
            against(Path(args.against).resolve())
        return 0

    # library_ms: no PyTorch call computes DTW.
    kernels = {name: {"name": fn, "route": "cuda", "source": f"{CSRC}/{name}.cu",
                      "replaces": replaces, "library_ms": None}
               for name, (fn, replaces) in KERNELS.items()}
    k1, k2, k3, k4, k5, k6, k7, k8 = (kernels[name] for name in KERNELS)
    # K8's Gram instantiation (dtw.dtype=bfloat16): the same source and
    # reference body, the launches of phase 31's bf16 job.
    k8_bf16 = kernels["dtw_long_block (Gram)"] = {
        **k8, "name": "dtw_long_batch(matmul_dtype=bfloat16)"}

    def per_pair(res: dict) -> None:
        k6.update(res["k6"])
        k7.update(res["k7"])

    def widen_job(res: dict) -> None:
        # K5's main-path cell is config 4 widen where the gate sends it
        # classes there, else long units widen (phase 15).
        k4["launches"] = res["launches"]
        if res["k5_launches"]:
            k5["launches"] = res["k5_launches"]

    def long_widen(res: dict) -> None:
        if not k5.get("launches"):
            k5["launches"] = res["launches"]

    def known_route(res: dict) -> None:
        # The known= route's launches, beside each kernel's main-path ones:
        # printed, and kept in PERF.md's kernel table.
        log(f"known= route launches: config 4 {json.dumps(res['config4'])}; out-of-order jobs "
            f"{json.dumps(res['ooo'])}")

    full_d: dict = {}   # phases 5 and 11's D, for phase 22
    long_units: dict = {}   # phase 28's features, for phase 31
    with tempfile.TemporaryDirectory(prefix="apd_smoke_") as tmp_dir:
        tmp = Path(tmp_dir)
        phases = [
            lambda: phase1(dev),
            lambda: k1.update(phase2(dev)),
            lambda: k1.update(phase3(dev, tmp)),
            lambda: phase4(tmp),
            lambda: phase5(dev, full_d),
            lambda: k2.update(phase6(dev)),
            lambda: k3.update(phase7(dev)),
            lambda: k2.update(phase8(tmp)),
            lambda: phase9(dev, tmp),
            lambda: k3.update(phase10(dev, tmp)),
            lambda: phase11(dev, full_d),
            lambda: k4.update(phase12(dev)),
            lambda: k5.update(phase13(dev)),
            lambda: widen_job(phase14(dev)),
            lambda: long_widen(phase15(dev, tmp)),
            lambda: per_pair(phase16(dev)),
            lambda: phase17(tmp),
            lambda: phase18(dev, tmp),
            lambda: k2.update(phase19(tmp)),
            lambda: phase20(dev, tmp),
            lambda: phase21(tmp),
            lambda: known_route(phase22(dev, full_d)),
            lambda: log(f"per-pair known= launches: {json.dumps(phase23(dev))}"),
            lambda: phase24(dev, tmp),
            lambda: phase25(tmp),
            lambda: phase26(dev, tmp),
            lambda: k8.update(phase27(dev)),
            lambda: k8.update(phase28(dev, tmp, long_units)),
            lambda: phase29(dev, tmp),
            lambda: phase30(dev, tmp),
            lambda: k8_bf16.update(phase31(dev, tmp, long_units)),
        ]
        t_all = time.perf_counter()
        for n, run in enumerate(phases, start=1):
            if n > 1 and only and n not in only:
                continue
            t0 = time.perf_counter()
            run()
            log(f"phase {n}: passed in {time.perf_counter() - t0:.1f} s")
        log(f"all phases: {time.perf_counter() - t_all:.1f} s")
    if "jax" in sys.modules:
        fail("JAX was imported")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
