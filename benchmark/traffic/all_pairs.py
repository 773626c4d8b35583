"""Traffic driver ``all_pairs``: one all-pairs DTW job after another over one
corpus of feature sequences made on the device from the seed.

A job is ``parallel.pair_scheduler.all_pairs_distances`` on the device
features (over the cell's cards where it has more than one), D back on the
host as NumPy.  Its work is the K(K-1)/2 pairs.

Configuration: ``K`` sequences of ``S`` frames of ``d`` channels, lengths
uniform in [S/2, S], zero past each length; ``dtw``: the port's
``DTWConfig`` fields.  Cell parameters (``params``): ``dtw``, fields
over the configuration's.  ``limits``: ``d_rel_max``, the largest gap of a
drawn entry of D (both triangles) from the reference's, over the reference.
The pairs are drawn from the seed, as many from every block of 128 x 128
of the index grid as make 512 pairs or more (one a block at K = 10,240),
and the pair of the two longest sequences besides.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.corpus import config4_corpus
from benchmark.reference.dtw import dtw_distances


def _dtw_fields(ctx) -> dict:
    return {**ctx.config["dtw"], **ctx.cell["params"].get("dtw", {})}


def corpus(ctx):
    """The seed's features and lengths, made on the device."""
    c = ctx.config
    return config4_corpus(c["K"], c["S"], c["d"], ctx.seed, ctx.device)


def setup(ctx) -> dict:
    from audio_pattern_discovery_tpu_torch.config import DTWConfig

    feats, lens = corpus(ctx)
    state = {"feats": feats, "lens": lens.cpu().numpy(), "dtw": DTWConfig(**_dtw_fields(ctx)),
             "device": ctx.device, "devices": ctx.devices if len(ctx.devices) > 1 else None}
    run_job(state)
    return state


def run_job(state) -> tuple[dict, np.ndarray]:
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances

    stats: dict = {}
    D = all_pairs_distances(state["feats"], state["lens"], state["dtw"], device=state["device"],
                            stats=stats, devices=state["devices"])
    K = len(state["lens"])
    return {"work": K * (K - 1) // 2, "stats": stats}, D


def release(state) -> None:
    state.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


BLOCK, LEAST = 128, 512


def drawn_pairs(ctx, lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The pairs (ia < ib) the check compares: ``ceil(LEAST / blocks)`` drawn
    from the seed in each of the ``blocks`` blocks of BLOCK x BLOCK indices
    on and above the diagonal, and the two longest sequences."""
    rng = np.random.default_rng([ctx.seed, 0xD7])
    K = len(lens)
    starts = np.arange(0, K, BLOCK)
    bi, bj = np.triu_indices(len(starts))
    n = -(-LEAST // len(bi))
    bi, bj = np.repeat(bi, n), np.repeat(bj, n)
    lo_i, lo_j = starts[bi], starts[bj]
    size_i, size_j = np.minimum(K - lo_i, BLOCK), np.minimum(K - lo_j, BLOCK)
    ia = lo_i + rng.integers(0, size_i)
    ib = lo_j + rng.integers(0, size_j)
    # On the diagonal, a second index other than the first, within the block.
    same = (bi == bj) & (size_i > 1)
    ib[same] = lo_i[same] + (ia[same] - lo_i[same] + rng.integers(1, size_i[same])) % size_i[same]
    keep = ia != ib
    ia, ib = np.minimum(ia, ib)[keep], np.maximum(ia, ib)[keep]
    top = np.sort(np.argsort(lens, kind="stable")[-2:])
    return np.concatenate([ia, top[:1]]), np.concatenate([ib, top[1:]])


def reference(ctx, ia, ib, precision: str = "fp64") -> np.ndarray:
    """The reference's distances of pairs (ia, ib), from the seed's inputs
    made again."""
    f = _dtw_fields(ctx)
    feats, lens = corpus(ctx)
    lens = lens.cpu().numpy()
    sel_a = torch.from_numpy(ia).to(ctx.device)
    sel_b = torch.from_numpy(ib).to(ctx.device)
    return dtw_distances(feats[sel_a], feats[sel_b], lens[ia], lens[ib], metric=f["metric"],
                         band=f["band"], band_mode=f["band_mode"], normalize=f["normalize"],
                         auto_widen=f["auto_widen_band"], precision=precision)


class ControlD:
    """The control in the program's place: any entries of D asked for come
    from the reference computed in bfloat16 (its Gram in bf16, fp32 sums)."""

    def __init__(self, ctx):
        self.ctx = ctx

    def __getitem__(self, key):
        ia, ib = (np.asarray(k) for k in key)
        lo, hi = np.minimum(ia, ib), np.maximum(ia, ib)
        return reference(self.ctx, lo, hi, precision="bf16")


def control(ctx, state):
    return ControlD(ctx)


def check(ctx, D) -> list[tuple[str, float, float]]:
    _, lens = corpus(ctx)
    ia, ib = drawn_pairs(ctx, lens.cpu().numpy())
    want = reference(ctx, ia, ib)
    gap = np.maximum(np.abs(np.asarray(D[ia, ib], np.float64) - want),
                     np.abs(np.asarray(D[ib, ia], np.float64) - want))
    rel = float(np.max(gap / np.maximum(np.abs(want), 1e-12)))
    return [("d_rel_max", rel if np.isfinite(rel) else float("inf"),
             float(ctx.cell["limits"]["d_rel_max"]))]
