"""Traffic driver ``discover_pca``: ``discover``'s jobs with the PCA embedding
(``autoencoder.method="pca"``), so nothing trains, and a check stage by
stage that follows the PCA and the per-pair route.

Set-up, jobs and release are ``discover``'s: one ``pipeline.discover`` run
after another over one corpus of WAVs written from the seed, in a closed
loop.  A job's stats add its segment lengths (``stats["lengths"]``), which
the roofline reader counts the DP cells from.  Configuration and
``limits``: as ``discover``'s (see ``check``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import pca as ref_pca
from benchmark.reference.ae import scaler
from benchmark.reference.cluster import cluster, partition_gap
from benchmark.reference.dtw import dtw_distances
from benchmark.reference.frontend import frames_gap, front_end
from benchmark.traffic import discover
from benchmark.traffic.discover import pipeline_config, release, result_arrays, setup  # noqa: F401

# Pairs of D the check compares, at least (all of them in a smaller job).
LEAST = 64
# The control: the reference in the nearest precision below the configuration's
# float32 with TF32 off.
CONTROL = "tf32"
# The relative eigengap under which a component's direction is set by
# rounding: an fp32 covariance turns a component of this corpus by 1e-7 to
# 1e-6 over its relative gap (2e-6 at gaps of 0.1, 2e-3 at 3e-5).
RESOLVED = 1e-2


def run_job(state) -> tuple[dict, tuple]:
    rec, out = discover.run_job(state)
    rec["stats"]["lengths"] = [int(n) for n in out[0].seg_lengths]
    return rec, out


def drawn_pairs(seed: int, lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pairs (ia < ib) drawn from the seed: the two longest segments' pair,
    the two shortest segments', the consecutive members of a permutation (so
    that every segment is in one pair or more), then pairs drawn at random up
    to ``LEAST``, or every pair where there are fewer."""
    rng = np.random.default_rng([seed, 0xD8])
    K = len(lengths)
    order = np.argsort(lengths, kind="stable")
    perm = rng.permutation(K)
    cand = [order[-2:], order[:2], *zip(perm[0::2], perm[1::2])]
    if K % 2:
        cand.append((perm[-1], perm[0]))
    pairs = {(int(min(a, b)), int(max(a, b))) for a, b in cand}
    want = min(LEAST, K * (K - 1) // 2)
    while len(pairs) < want:
        a, b = rng.choice(K, 2, replace=False)
        pairs.add((int(min(a, b)), int(max(a, b))))
    ia, ib = np.array(sorted(pairs)).T
    return ia, ib


def _budget(dev) -> int:
    """Bytes the reference DTW may take a block: half of what the card has
    free once the program's state is freed (1 GiB on the CPU)."""
    if torch.device(dev).type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[0] // 2)
    return 1 << 30


def _pca_reference(r: dict, cfg: dict, dev, precision: str = "fp64") -> tuple:
    """The reference PCA fitted on the segment frames the program's embedding
    stage got, standardized by a scaler fitted on them again: its latents
    of those frames ([N, k], the segments' valid frames in order) and its
    resolved components ([k] bool, ``RESOLVED``)."""
    ae = cfg["autoencoder"]
    if ae["context_frames"]:
        raise ValueError("the check follows single-frame embeddings (context_frames 0)")
    flat = np.concatenate([r["ae_frames"][k, :n] for k, n in enumerate(r["lengths"])])
    mean, std = scaler(flat)
    x = (torch.from_numpy(flat).to(dev).double() - torch.from_numpy(mean).to(dev)) / \
        torch.from_numpy(std).to(dev)
    del flat
    state = ref_pca.fit(x, ae["latent_dim"], ae["pca_whiten"], precision)
    return (ref_pca.project(x, state, precision).cpu().numpy(),
            ref_pca.resolved(state["eigenvalues"], ae["latent_dim"], RESOLVED))


def _d_reference(r: dict, cfg: dict, ctx, ia, ib, precision: str = "fp64") -> np.ndarray:
    """The reference's distances of pairs (ia, ib) over the features the
    program's DTW stage got."""
    dt = cfg["dtw"]
    feats, lens = torch.from_numpy(r["d_input"]).to(ctx.device), r["lengths"]
    sel_a, sel_b = torch.from_numpy(ia).to(ctx.device), torch.from_numpy(ib).to(ctx.device)
    return dtw_distances(feats[sel_a], feats[sel_b], lens[ia], lens[ib], metric=dt["metric"],
                         band=dt["band"], band_mode=dt["band_mode"], normalize=dt["normalize"],
                         auto_widen=dt["auto_widen_band"], precision=precision,
                         budget=_budget(ctx.device))


def control(ctx, state) -> dict:
    """The reference computed in TF32 in the program's place, stage by stage,
    each stage from what the program's stage before it gave: the front end
    on TF32 frames; the PCA fitted and projected in TF32 on the program's
    frames; the drawn entries of D from TF32 Gram costs over the program's
    features (the rest of D the program's, which the check does not read but
    the clustering does), the clustering of that D."""
    _, out = run_job(state)
    r = result_arrays(*out)
    del out
    cfg = pipeline_config(ctx).to_dict()
    valid = np.arange(r["features"].shape[1])[None, :] < r["lengths"][:, None]
    r["features"] = r["features"].copy()
    r["features"][valid] = _pca_reference(r, cfg, ctx.device, CONTROL)[0]
    segs, frames, _ = front_end(discover._wavs(ctx), cfg["spectrogram"], cfg["segmentation"],
                                cfg["dtw"]["max_seq_len"], precision=CONTROL)
    r["segments"], r["frames"] = segs, frames.astype(np.float32)
    del frames
    ia, ib = drawn_pairs(ctx.seed, r["lengths"])
    D = np.array(r["D"], np.float64)
    D[ia, ib] = D[ib, ia] = _d_reference(r, cfg, ctx, ia, ib, CONTROL)
    r["D"], r["labels"] = D, cluster(D, cfg["cluster"])
    return r


def check(ctx, res) -> list[tuple[str, float, float]]:
    """Stage by stage, each from what the program's stage before it gave:

    - ``segments_moved``: segments in one table and not the other (exact),
      the reference's front end from the WAVs;
    - ``frames_rel_max``: the largest gap of a bin's power in the segments'
      spectra, over its frame's power;
    - ``pca_features_rel_max``: the largest gap of a latent inside a
      segment's length from the reference PCA's latents (fitted on the
      program's segment frames, standardized again), over their root mean
      square, in the resolved components (``RESOLVED``: at this corpus's
      noise floor eigenvalues tie to 1e-5 of themselves, and rounding alone
      turns those components by up to 2e-3);
    - ``d_rel_max``: the largest gap of a drawn entry of D (both triangles)
      from the reference's DTW over the features the program's DTW stage
      got, over the reference (``drawn_pairs``: the float64 reference takes
      1.6 GB and 16k anti-diagonal steps an 8192-frame pair);
    - ``partition_moved``: segments whose cluster mates differ from the
      reference's clustering of the program's D (exact).

    No path is compared: the configuration writes no alignments."""
    r = res if isinstance(res, dict) else result_arrays(*res)
    del res
    cfg, lim, dev = pipeline_config(ctx).to_dict(), ctx.cell["limits"], ctx.device
    max_len = cfg["dtw"]["max_seq_len"]
    segs, frames, _ = front_end(discover._wavs(ctx), cfg["spectrogram"], cfg["segmentation"],
                                max_len)
    out = [("segments_moved", float(len(set(segs) ^ set(r["segments"]))))]
    mine = {s: k for k, s in enumerate(r["segments"])}
    common = [(mine[s], k) for k, s in enumerate(segs) if s in mine]
    got, want = r["frames"][[a for a, _ in common]], frames[[b for _, b in common]]
    lens = np.array([min(s[2] - s[1], max_len) for s in segs])[[b for _, b in common]]
    out.append(("frames_rel_max", frames_gap(got, want, lens)))
    del frames, got, want

    valid = np.arange(r["features"].shape[1])[None, :] < r["lengths"][:, None]
    f_ref, keep = _pca_reference(r, cfg, dev)
    f_ref = f_ref[:, keep]
    gap = np.max(np.abs(r["features"][valid][:, keep] - f_ref))
    out.append(("pca_features_rel_max", gap / np.sqrt(np.mean(f_ref ** 2))))
    del f_ref

    ia, ib = drawn_pairs(ctx.seed, r["lengths"])
    want = _d_reference(r, cfg, ctx, ia, ib)
    D = np.asarray(r["D"], np.float64)
    gap = np.maximum(np.abs(D[ia, ib] - want), np.abs(D[ib, ia] - want))
    out.append(("d_rel_max", np.max(gap / np.maximum(np.abs(want), 1e-12))))
    out.append(("partition_moved", partition_gap(r["labels"], cluster(D, cfg["cluster"]))))
    return [(n, discover._finite(v), float(lim[n])) for n, v in out]
