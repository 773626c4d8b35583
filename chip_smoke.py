#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each one passes or the script exits non-zero, and prints its
seconds):

1. device: a CUDA card is required; prints its name and power limit and
   builds the kernels K1, K2 and K3 from
   ``audio_pattern_discovery_tpu_torch/csrc`` (one nvcc each, started
   together);
2. K1 against its plain PyTorch twin on the card at the config-4 tile shape
   (d=16, S=128, band=16, lengths 64-128; euclidean on 10 tile-pairs,
   sqeuclidean and cosine on 2), plus an out-of-frame call that must come
   back all +inf; prints both times;
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
   widen band 8 (auto_widen on and off) on 2, and a ``rows`` shortfall that
   must be +inf on exactly the cut rows; prints both times;
7. K3 against its twin on the card (S=1024, d=16, ti=128, 2 tiles, lengths
   257-1024) on all 3 tile-pairs, plus a ``width`` and a ``rows``
   shortfall that must come back +inf; prints both times;
8. config 2 through the CLI at its default DTW (no band: K2);
9. ``discover()`` on the seed-7 corpus unbanded on the card and on the
   CPU in this process: D at rtol 1e-4 / atol 1e-5, partition exact;
10. long units (24 clips of 20 s with 3-5 s motifs, segments up to 1024
   frames): K3 and the checkpointed backtrace through ``discover()``; 16
   distances against the NumPy oracle;
11. config 4 unbanded through the scheduler (K2); prints pairs/s, the
   kernel's device time and the scatter's seconds, checks 64 pairs against
   the plain torch DTW and 8 against the oracle; the native scatter must
   have run.

The line before the last is a JSON object with the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``.  Everything else goes to
earlier lines.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import multiprocessing
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "GOLDEN_cpu_seed7_mfcc_pca.npz"
PALLAS = "audio_pattern_discovery_tpu/ops/dtw_pallas.py"
CSRC = "audio_pattern_discovery_tpu_torch/csrc"
KERNELS = {   # source name -> (entry function, kernel body it replaces)
    "dtw_lane_diag": ("dtw_tile_lane_diag_pairs", f"{PALLAS}:1747"),
    "dtw_tile": ("dtw_tile_pairs", f"{PALLAS}:570"),
    "dtw_lane_full": ("dtw_tile_lane_full_pairs", f"{PALLAS}:2307"),
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
# K3's warp scan reassociates the additions along each DP row (the twin adds
# cell by cell), so each side is within n * 2^-24 of the exact sum and the
# two within 2 (la+lb) * 2^-24 + d * 2^-24 relative: 2.5e-4 at S=1024.
K3_RTOL, K3_ATOL = 2.5e-4, 1e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    log(f"phase 1: K1, K2, K3 loaded in {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        secs, ptxas = _build.build_info.get(name, (0.0, "(already built)"))
        log(f"  {name}.cu built in {secs:.2f} s")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")
    return {}


def phase2(dev) -> dict:
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
        diag_class_bounds,
        dtw_tile_lane_diag_pairs,
        dtw_tile_lane_diag_pairs_ref,
        tile_rep_lengths,
    )

    ti, nT, S, d, band = 128, 4, 128, 16, 16
    feats, lens = config4_corpus(ti * nT, S, d, seed=1, dev=dev)
    order = torch.argsort(lens, stable=True)
    feats, lens = feats[order].contiguous(), lens[order].contiguous()
    lens_np = lens.cpu().numpy()
    rep = torch.from_numpy(tile_rep_lengths(lens_np, nT, ti, len(lens_np))).to(dev)
    tmin = [int(lens_np[t * ti:(t + 1) * ti].min()) for t in range(nT)]
    tmax = [int(lens_np[t * ti:(t + 1) * ti].max()) for t in range(nT)]
    # All upper tile-pairs long side on rows (as the scheduler orients
    # them): 4 diagonal tiles and 6 cross-tile pairs, (3, 0) the widest
    # length spread.
    pairs = [(j, i) for i in range(nT) for j in range(i, nT)]
    wv = max(diag_class_bounds(band, tmin[a], tmax[a], tmin[b], tmax[b])[0] for a, b in pairs)
    rows = max(tmax[a] for a, _ in pairs)
    ii = torch.tensor([p[0] for p in pairs], dtype=torch.int32, device=dev)
    jj = torch.tensor([p[1] for p in pairs], dtype=torch.int32, device=dev)
    kw = dict(ti=ti, band=band, wv_max=wv, rows=rows)
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
    ms = cuda_ms(lambda: dtw_tile_lane_diag_pairs(feats, lens, rep, ii, jj, **kw), 20)
    plain_ms = cuda_ms(lambda: dtw_tile_lane_diag_pairs_ref(feats, lens, rep, ii, jj, **kw), 3)
    n_pairs = len(pairs) * ti * ti
    log(f"phase 2: K1 vs plain on {len(pairs)} tile-pairs ({n_pairs} pairs, W={2 * wv + 2}, "
        f"rows={rows}): max abs err {max_abs:.3g} (rtol {K1_RTOL}, atol {K1_ATOL}); "
        f"sqeuclidean and cosine agree; out-of-frame all +inf")
    log(f"phase 2: K1 {ms:.3f} ms/call ({n_pairs / ms * 1e3:.0f} pairs/s), "
        f"plain {plain_ms:.3f} ms/call ({n_pairs / plain_ms * 1e3:.0f} pairs/s)")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


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


def phase4(tmp: Path) -> dict:
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    corpus, out = tmp / "config2", tmp / "config2_out"
    make_corpus(corpus, n_clips=100, n_motifs=5, occurrences_per_clip=4,
                clip_seconds=10.0, sample_rate=44_100, seed=2)
    cmd = [sys.executable, "-m", "audio_pattern_discovery_tpu_torch", str(corpus),
           "-o", str(out), "-s", "dtw.band=16", "-s", "autoencoder.method=pca"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 4: CLI exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout)
    manifest = json.loads((out / "clusters.json").read_text())
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


def phase5(dev) -> dict:
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.oracle.dtw import dtw_oracle
    from audio_pattern_discovery_tpu_torch.ops.dtw import dtw_batch
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_lane_diag_pairs
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances

    K, S, d, band = 10_240, 128, 16, 16
    feats, lens = config4_corpus(K, S, d, seed=4, dev=dev)
    lens_np = lens.cpu().numpy()
    cfg = DTWConfig(band=band, band_mode="diag", normalize="path_len")
    stats: dict = {}
    dtw_tile_lane_diag_pairs.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D = all_pairs_distances(feats, lens_np, cfg, device=dev, stats=stats)
    wall = time.perf_counter() - t0
    launches = dtw_tile_lane_diag_pairs.launches
    n_pairs = K * (K - 1) // 2
    if not np.isfinite(D).all():
        fail("phase 5: non-finite distances in D")
    rng = np.random.default_rng(5)
    ia = rng.integers(0, K, 64)
    ib = (ia + rng.integers(1, K, 64)) % K
    sel_a = torch.from_numpy(ia).to(dev)
    sel_b = torch.from_numpy(ib).to(dev)
    want = dtw_batch(feats[sel_a], feats[sel_b], lens[sel_a], lens[sel_b], band=band,
                     band_mode="diag", normalize="path_len").cpu().numpy()
    got = D[ia, ib]
    if not np.allclose(got, want, rtol=1e-4, atol=1e-5):
        fail(f"phase 5: D disagrees with plain dtw_batch (max abs {np.abs(got - want).max()})")
    f_np = feats.cpu().numpy()
    for a, b in zip(ia[:8], ib[:8]):
        ref = dtw_oracle(f_np[a, :lens_np[a]], f_np[b, :lens_np[b]], band=band,
                         band_mode="diag", normalize="path_len")
        if not np.isclose(D[a, b], ref, rtol=1e-4, atol=1e-5):
            fail(f"phase 5: D[{a},{b}]={D[a, b]} vs oracle {ref}")
    if not stats["native_scatter"]:
        fail("phase 5: the scheduler scattered with NumPy: the native library did not load")
    s = {k: round(v, 3) if isinstance(v, float) else v for k, v in stats.items()}
    log(f"phase 5: config 4 all-pairs K={K}: {n_pairs} pairs in {wall:.2f} s = "
        f"{n_pairs / wall:.0f} pairs/s; K1 device time {stats['kernel_s']:.3f} s "
        f"({stats['kernel_s'] / wall:.1%} of wall), launches {launches}; 64 pairs match plain "
        f"dtw_batch, 8 match the oracle; stats {s}")
    return {}


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
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_pairs, dtw_tile_pairs_ref

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
    ms = cuda_ms(lambda: dtw_tile_pairs(feats, lens, ii, jj, **kw), 10)
    plain_ms = cuda_ms(lambda: dtw_tile_pairs_ref(feats, lens, ii, jj, **kw), 1, warm=False)
    n_pairs = len(pairs) * ti * ti
    log(f"phase 6: K2 vs plain on {len(pairs)} tile-pairs ({n_pairs} pairs, S={S}, "
        f"rows={kw['rows']}): max abs err {max_abs:.3g} (rtol {K2_RTOL}, atol {K2_ATOL}); "
        f"sqeuclidean, cosine and widen band 8 agree; rows shortfall +inf on "
        f"{int(over[:, 0].sum())} cut rows")
    log(f"phase 6: K2 {ms:.3f} ms/call ({n_pairs / ms * 1e3:.0f} pairs/s), "
        f"plain {plain_ms:.3f} ms/call ({n_pairs / plain_ms * 1e3:.0f} pairs/s)")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def phase7(dev) -> dict:
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
        dtw_tile_lane_full_pairs,
        dtw_tile_lane_full_pairs_ref,
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
    ms = cuda_ms(lambda: dtw_tile_lane_full_pairs(feats, lens, ii, jj, **kw), 3)
    n_pairs = 3 * ti * ti
    log(f"phase 7: K3 vs plain on 3 tile-pairs ({n_pairs} pairs, S={S}, width {kw['width']}): "
        f"max abs err {max_abs:.3g} (rtol {K3_RTOL}, atol {K3_ATOL}); width and rows "
        f"shortfalls +inf on exactly the cut pairs")
    log(f"phase 7: K3 {ms:.3f} ms/call ({n_pairs / ms * 1e3:.0f} pairs/s), "
        f"plain {plain_ms:.3f} ms/call ({n_pairs / plain_ms * 1e3:.0f} pairs/s)")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def phase8(tmp: Path) -> dict:
    corpus, out = tmp / "config2", tmp / "config2_unbanded_out"
    cmd = [sys.executable, "-m", "audio_pattern_discovery_tpu_torch", str(corpus),
           "-o", str(out), "-s", "autoencoder.method=pca"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 8: CLI exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout)
    manifest = json.loads((out / "clusters.json").read_text())
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


def phase10(dev, tmp: Path) -> dict:
    from audio_pattern_discovery_tpu_torch.config import PipelineConfig
    from audio_pattern_discovery_tpu_torch.oracle.dtw import dtw_oracle
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_lane_full_pairs
    from audio_pattern_discovery_tpu_torch.pipeline import discover
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    corpus = tmp / "long_units"
    make_corpus(corpus, n_clips=24, n_motifs=3, occurrences_per_clip=2, clip_seconds=20.0,
                motif_seconds=(3.0, 5.0), sample_rate=44_100, seed=10)
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
    # The oracle walks its float64 DP cell by cell in Python (~3 s for a
    # pair of 700-frame segments): 8 worker processes share the pairs.
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as pool:
        wants = list(pool.map(partial(dtw_oracle, normalize="path_len"),
                              [f[a, :n[a]] for a in ia], [f[b, :n[b]] for b in ib]))
    for a, b, want in zip(ia, ib, wants):
        if not np.isclose(D[a, b], want, rtol=K3_RTOL, atol=1e-5):
            fail(f"phase 10: D[{a},{b}]={D[a, b]} vs oracle {want}")
    t = {k: round(v, 3) for k, v in res.counters.timings_s.items()}
    log(f"phase 10: long units ({len(n)} segments of {int(n.min())}-{int(n.max())} frames, "
        f"{len(res.clusters)} clusters): K3 launches {launches}, {ckpt} clusters aligned "
        f"through the checkpointed backtrace, 16 distances match the oracle; discover() "
        f"wall {wall:.2f} s; stages {t}")
    return {"launches": launches}


def phase11(dev) -> dict:
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.oracle.dtw import dtw_oracle
    from audio_pattern_discovery_tpu_torch.ops.dtw import dtw_batch
    from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import dtw_tile_pairs
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances

    K, S, d = 10_240, 128, 16
    feats, lens = config4_corpus(K, S, d, seed=4, dev=dev)
    lens_np = lens.cpu().numpy()
    cfg = DTWConfig(band=None, normalize="path_len")
    stats: dict = {}
    dtw_tile_pairs.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D = all_pairs_distances(feats, lens_np, cfg, device=dev, stats=stats)
    wall = time.perf_counter() - t0
    launches = dtw_tile_pairs.launches
    n_pairs = K * (K - 1) // 2
    if launches < 1 or stats["route"] != "tile":
        fail(f"phase 11: the job took route {stats['route']} with {launches} K2 launches")
    if not stats["native_scatter"]:
        fail("phase 11: the scheduler scattered with NumPy: the native library did not load")
    if not np.isfinite(D).all():
        fail("phase 11: non-finite distances in D")
    rng = np.random.default_rng(11)
    ia = rng.integers(0, K, 64)
    ib = (ia + rng.integers(1, K, 64)) % K
    sel_a, sel_b = torch.from_numpy(ia).to(dev), torch.from_numpy(ib).to(dev)
    want = dtw_batch(feats[sel_a], feats[sel_b], lens[sel_a], lens[sel_b],
                     normalize="path_len").cpu().numpy()
    if not np.allclose(D[ia, ib], want, rtol=1e-4, atol=1e-5):
        fail(f"phase 11: D disagrees with plain dtw_batch (max abs {np.abs(D[ia, ib] - want).max()})")
    f_np = feats.cpu().numpy()
    for a, b in zip(ia[:8], ib[:8]):
        ref = dtw_oracle(f_np[a, :lens_np[a]], f_np[b, :lens_np[b]], normalize="path_len")
        if not np.isclose(D[a, b], ref, rtol=1e-4, atol=1e-5):
            fail(f"phase 11: D[{a},{b}]={D[a, b]} vs oracle {ref}")
    s = {k: round(v, 3) if isinstance(v, float) else v for k, v in stats.items()}
    log(f"phase 11: config 4 unbanded all-pairs K={K}: {n_pairs} pairs in {wall:.2f} s = "
        f"{n_pairs / wall:.0f} pairs/s; K2 device time {stats['kernel_s']:.3f} s "
        f"({stats['kernel_s'] / wall:.1%} of wall), launches {launches}; 64 pairs match plain "
        f"dtw_batch, 8 match the oracle; stats {s}")
    return {}


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card only")
    dev = torch.device("cuda", 0)
    import audio_pattern_discovery_tpu_torch  # noqa: F401  (sets the TF32 flags)

    kernels = {name: {"name": fn, "route": "cuda", "source": f"{CSRC}/{name}.cu",
                      "replaces": replaces}
               for name, (fn, replaces) in KERNELS.items()}
    k1, k2, k3 = (kernels[name] for name in KERNELS)
    with tempfile.TemporaryDirectory(prefix="apd_smoke_") as tmp_dir:
        tmp = Path(tmp_dir)
        phases = [
            lambda: phase1(dev),
            lambda: k1.update(phase2(dev)),
            lambda: k1.update(phase3(dev, tmp)),
            lambda: phase4(tmp),
            lambda: phase5(dev),
            lambda: k2.update(phase6(dev)),
            lambda: k3.update(phase7(dev)),
            lambda: k2.update(phase8(tmp)),
            lambda: phase9(dev, tmp),
            lambda: k3.update(phase10(dev, tmp)),
            lambda: phase11(dev),
        ]
        for n, run in enumerate(phases, start=1):
            t0 = time.perf_counter()
            run()
            log(f"phase {n}: passed in {time.perf_counter() - t0:.1f} s")
    if "jax" in sys.modules:
        fail("JAX was imported")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
