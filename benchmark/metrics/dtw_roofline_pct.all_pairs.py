"""dtw_roofline_pct.all_pairs: the job's least time over the device time of
every kernel in the traced jobs, per job, in %.  The least time is the larger
of the DP cells the lengths and the band need at (3d+4) fp32 operations each
over 67 TFLOP/s, and the features read once and D written once over
3.35 TB/s (``benchmark/roofline.py``); both counts come from the job's
shapes, whatever kernel does the work."""

from benchmark.roofline import job_bound_s


def read(run):
    if not run.trace or run.trace["kernel_s"] <= 0:
        return None
    ctx = run.ctx
    c, dtw = ctx.config, {**ctx.config["dtw"], **ctx.cell["params"].get("dtw", {})}
    from benchmark.corpus import config4_corpus

    _, lens = config4_corpus(c["K"], c["S"], c["d"], ctx.seed, ctx.device)
    kind = "full" if dtw["band"] is None else dtw["band_mode"]
    least = job_bound_s(lens.cpu().numpy(), c["S"], c["d"], kind, dtw["band"])
    return 100.0 * least / (run.trace["kernel_s"] / len(run.jobs))
