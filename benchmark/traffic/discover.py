"""Traffic driver ``discover``: one ``pipeline.discover`` run after another
over one corpus of WAVs written from the seed.

A job is the port's ``discover()`` on the corpus directory, on the cell's
device (its list of cards where it has more than one), with no output
directory (artifacts are not written).  Its work is one run; its stats are
the run's stage seconds and counts.  The parameters that the
run's AE training returns are kept beside its result for the check (the
pipeline's own call, wrapped to keep a reference to them).

Configuration: ``corpus``, the arguments of ``make_corpus`` (the seed is
the run's); ``pipeline``, dotted overrides of the port's shipped
``PipelineConfig`` (none: the configuration as shipped).  ``limits``: see
``check``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.corpus import make_corpus
from benchmark.reference import ae as ref_ae
from benchmark.reference.cluster import cluster, partition_gap
from benchmark.reference.dtw import dtw_distances, path_excess, warping_paths
from benchmark.reference.frontend import frames_gap, front_end


def pipeline_config(ctx, overrides: dict | None = None):
    from audio_pattern_discovery_tpu_torch.config import PipelineConfig

    dotted = {**ctx.config.get("pipeline", {}), **(overrides or {})}
    return PipelineConfig().override(dotted).validate() if dotted else PipelineConfig().validate()


def write_corpus(ctx):
    corpus = ctx.tmp / "corpus"
    c = ctx.config["corpus"]
    make_corpus(corpus, c["n_clips"], c["n_motifs"], c["occurrences_per_clip"],
                c["clip_seconds"], tuple(c["motif_seconds"]), c["sample_rate"],
                c["noise_db"], ctx.seed)
    return corpus


def _keep_trained(state) -> None:
    """Wrap the pipeline's ``train_autoencoder`` so that the parameters it
    returns (its ``TrainState.params``) are kept in ``state["trained"]``;
    ``release`` puts the original back."""
    import audio_pattern_discovery_tpu_torch.pipeline as pipeline

    train = pipeline.train_autoencoder

    def kept(*args, **kw):
        out = train(*args, **kw)
        state["trained"] = out[1].params
        return out

    pipeline.train_autoencoder = kept
    state["restore"] = lambda: setattr(pipeline, "train_autoencoder", train)


def setup(ctx) -> dict:
    state = {"corpus": write_corpus(ctx), "cfg": pipeline_config(ctx), "ctx": ctx}
    _keep_trained(state)
    run_job(state)
    return state


def run_job(state) -> tuple[dict, tuple]:
    from audio_pattern_discovery_tpu_torch.pipeline import discover

    ctx = state["ctx"]
    state["trained"] = None
    res = discover(state["corpus"], state["cfg"], out_dir=None, logger=ctx.log,
                   device=ctx.program_device)
    return {"work": 1, "stats": {"timings_s": dict(res.counters.timings_s),
                                 "counts": dict(res.counters.counts)}}, (res, state["trained"])


def release(state) -> None:
    if "restore" in state:
        state["restore"]()
    state.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def control(ctx, state) -> dict:
    """The reference computed in bfloat16 in the program's place, stage by
    stage, each stage from what the program's stage before it gave (as the
    check follows the program): the front end on bf16 frames; the AE trained
    in bf16 on the program's frames, and its features of them; D and the
    alignment paths from bf16 Gram costs over the program's features (the
    bf16 encoder's latents are bf16 values already, which a bf16 Gram holds
    exactly), the clustering of that D."""
    _, out = run_job(state)
    r = result_arrays(*out)
    del out
    cfg, dev = pipeline_config(ctx).to_dict(), ctx.device
    segs, frames, _ = front_end(_wavs(ctx), cfg["spectrogram"], cfg["segmentation"],
                                cfg["dtw"]["max_seq_len"], precision="bf16")
    ref = _ae_reference(r, cfg, dev, "bfloat16")
    r["ae_losses"], r["ae_params"] = ref["losses"], ref["final"]
    r["features"] = ref["features"]
    r["segments"], r["frames"] = segs, frames.astype(np.float32)
    kw = _dtw_kw(cfg)
    feats, K = torch.from_numpy(r["d_input"]).to(dev), len(r["lengths"])
    ia, ib = np.triu_indices(K, 1)
    d = _pairs(dtw_distances, feats, r["lengths"], ia, ib, normalize=cfg["dtw"]["normalize"],
               precision="bf16", **kw)
    D = np.zeros((K, K))
    D[ia, ib] = D[ib, ia] = d
    r["D"], r["labels"] = D, cluster(D, cfg["cluster"])
    pairs = []
    for lab in np.unique(r["labels"]):
        members = np.flatnonzero(r["labels"] == lab)
        if len(members) < max(2, cfg["cluster"]["min_cluster_size"]):
            continue
        ex = int(members[np.argmin(D[np.ix_(members, members)].sum(1))])
        pairs += [(ex, int(m)) for m in members if m != ex]
    ea, mb = np.array([p[0] for p in pairs], int), np.array([p[1] for p in pairs], int)
    paths = _pairs(warping_paths, feats, r["lengths"], ea, mb, precision="bf16", **kw)
    r["alignments"] = [(a, b, p) for (a, b), p in zip(pairs, paths)]
    return r


def result_arrays(res, trained=None) -> dict:
    """What the check reads of a ``DiscoveryResult`` and of the parameters
    its AE training returned (a state dict; None where nothing trained)."""
    names = sorted(trained or {}, key=_leaf_order)
    return {
        "ae_params": [trained[n].detach().float().cpu() for n in names],
        "segments": [(s.clip, s.start_frame, s.end_frame) for s in res.segments],
        "frames": np.asarray(res.seg_spectrograms, np.float32),
        "ae_frames": np.asarray(res.seg_spectrograms, np.float32),
        "features": np.asarray(res.seg_features, np.float32),
        "d_input": np.asarray(res.seg_features, np.float32),
        "lengths": np.asarray(res.seg_lengths, np.int64),
        "D": np.asarray(res.distance_matrix),
        "labels": np.asarray(res.labels),
        "ae_losses": [float(x) for x in res.ae_losses],
        "alignments": [(rep.exemplar, m, p) for rep in res.clusters
                       for m, p in rep.alignments.items()],
    }


def _wavs(ctx) -> list:
    return sorted((ctx.tmp / "corpus").glob("*.wav"))


def _dtw_kw(cfg: dict) -> dict:
    dt = cfg["dtw"]
    return dict(metric=dt["metric"], band=dt["band"], band_mode=dt["band_mode"],
                auto_widen=dt["auto_widen_band"])


def _pairs(fn, feats, lengths, ia, ib, **kw):
    """``fn`` of the reference over pairs (ia, ib) of the features."""
    dev = feats.device
    return fn(feats[torch.from_numpy(ia).to(dev)], feats[torch.from_numpy(ib).to(dev)],
              lengths[ia], lengths[ib], **kw)


def _leaf_order(name: str) -> tuple:
    """A state dict's AE leaves in the reference's order: the encoder's
    layers, then the decoder's, each weight before its bias."""
    part, i, kind = name.split(".")
    return (part != "enc_layers", int(i), kind != "weight")


def _ae_reference(r: dict, cfg: dict, dev, dtype: str = "float32") -> dict:
    """The reference AE trained, for every configured epoch, on the segment
    frames the program's AE stage got, standardized by a scaler fitted on
    them again; with ``"features"``, its latents of every segment's frames."""
    flat = np.concatenate([r["ae_frames"][k, :n] for k, n in enumerate(r["lengths"])])
    mean, std = ref_ae.scaler(flat)
    ref = ref_ae.train((flat - mean) / std, cfg["autoencoder"], dev, dtype)
    x = (torch.from_numpy(r["ae_frames"]).to(dev) - torch.from_numpy(mean).to(dev)) / \
        torch.from_numpy(std).to(dev)
    ref["features"] = ref_ae.encode(x, ref["enc"], cfg["autoencoder"]["activation"],
                                    dtype).cpu().numpy()
    ref["final"] = [t.float().cpu() for t in ref["final"]]
    ref["init"] = [t.float().cpu() for t in ref["init"]]
    return ref


def ae_gaps(r: dict, ref: dict) -> dict:
    """The AE's numbers against the reference's training:

    - ``ae_loss_rel_max``: the largest relative gap of an epoch's mean loss;
    - ``ae_change_gap``: by the worst leaf, the gap between the norms of the
      program's and the reference's change from the initial parameters, over
      the larger of the reference's norm of that leaf's change and of the
      median leaf's.  Leaves whose first gradient in the reference is under
      a thousandth of the median leaf's are left out;
    - ``features_rel_max``: the largest gap of a latent value inside a
      segment's length from the reference's latents of the same frames, over
      the root mean square of those latents."""
    want, got = ref["losses"], r["ae_losses"]
    loss = (max(abs(g - w) / w for g, w in zip(got, want)) if len(got) == len(want)
            else float("inf"))
    change, kept = float("inf"), []
    if len(r["ae_params"]) == len(ref["init"]):
        g1 = np.array(ref["grad1"])
        kept = np.flatnonzero(g1 >= 1e-3 * np.median(g1))
        ref_n = np.array([float((f - i).norm()) for f, i in zip(ref["final"], ref["init"])])
        got_n = np.array([float((p - i).norm()) if p.shape == i.shape else np.inf
                          for p, i in zip(r["ae_params"], ref["init"])])
        scale = np.maximum(ref_n, np.median(ref_n[kept]))
        change = float(np.max((np.abs(got_n - ref_n) / scale)[kept]))
    valid = np.arange(r["features"].shape[1])[None, :] < r["lengths"][:, None]
    f_ref = ref["features"][valid].astype(np.float64)
    gap = np.abs(r["features"][valid] - f_ref)
    feats = float(np.max(gap) / np.sqrt(np.mean(f_ref ** 2)))
    return {"ae_loss_rel_max": loss, "ae_change_gap": change, "features_rel_max": feats}


def check(ctx, res) -> list[tuple[str, float, float]]:
    """Stage by stage, each from what the program's stage before it gave
    (the AE's training amplifies rounding, so the reference cannot follow
    the program's weights from the WAVs alone):

    - ``segments_moved``: segments in one table and not the other (exact),
      the reference's front end from the WAVs;
    - ``frames_rel_max``: the largest gap of a bin's power in the segments'
      spectra, over its frame's power;
    - ``ae_loss_rel_max``, ``ae_change_gap``, ``features_rel_max``: the AE's
      training and features against the reference AE trained for every
      epoch on the program's segment frames (``ae_gaps``);
    - ``d_rel_max``: the largest gap of an entry of D (both triangles) from
      the reference's DTW over the features the program's DTW stage got,
      over the reference;
    - ``partition_moved``: segments whose cluster mates differ from the
      reference's clustering of the reference's D (exact);
    - ``path_excess_max``: the largest excess of an alignment path's cost
      over the least (reference costs on the program's features)."""
    r = res if isinstance(res, dict) else result_arrays(*res)
    del res
    cfg, lim, dev = pipeline_config(ctx).to_dict(), ctx.cell["limits"], ctx.device
    segs, frames, _ = front_end(_wavs(ctx), cfg["spectrogram"], cfg["segmentation"],
                                cfg["dtw"]["max_seq_len"])
    out = [("segments_moved", float(len(set(segs) ^ set(r["segments"]))))]
    mine = {s: k for k, s in enumerate(r["segments"])}
    common = [(mine[s], k) for k, s in enumerate(segs) if s in mine]
    got, want = r["frames"][[a for a, _ in common]], frames[[b for _, b in common]]
    lens = np.array([min(s[2] - s[1], cfg["dtw"]["max_seq_len"]) for s in segs])[
        [b for _, b in common]]
    out.append(("frames_rel_max", frames_gap(got, want, lens)))

    out += list(ae_gaps(r, _ae_reference(r, cfg, dev)).items())

    kw = _dtw_kw(cfg)
    feats, K = torch.from_numpy(r["d_input"]).to(dev), len(r["lengths"])
    ia, ib = np.triu_indices(K, 1)
    want = _pairs(dtw_distances, feats, r["lengths"], ia, ib,
                  normalize=cfg["dtw"]["normalize"], **kw)
    gap = np.maximum(np.abs(r["D"][ia, ib] - want), np.abs(r["D"][ib, ia] - want))
    out.append(("d_rel_max", np.max(gap / np.maximum(np.abs(want), 1e-12))))

    D_ref = np.zeros((K, K))
    D_ref[ia, ib] = D_ref[ib, ia] = want
    out.append(("partition_moved", partition_gap(r["labels"], cluster(D_ref, cfg["cluster"]))))

    al = r["alignments"]
    if al:
        ea, mb = np.array([a for a, _, _ in al]), np.array([b for _, b, _ in al])
        worst = np.max(_pairs(path_excess, feats, r["lengths"], ea, mb,
                              paths=[p for _, _, p in al], **kw))
    else:
        worst = float("inf") if cfg["output"]["write_alignments"] else 0.0
    out.append(("path_excess_max", worst))
    return [(n, _finite(v), float(lim[n])) for n, v in out]


def _finite(x) -> float:
    x = float(x)
    return x if np.isfinite(x) else float("inf")
