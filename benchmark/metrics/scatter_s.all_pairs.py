"""scatter_s.all_pairs: seconds a job of the scheduler's assembly of D from
each tile's distances (``stats["scatter_s"]``): where D is assembled on the
card, the host's time queueing the scatter kernels and the un-permute and
the copy of D to the host after the final synchronize; on the host path,
its span around the native scatter.  The mean over the traced jobs."""


def read(run):
    vals = [j["stats"]["scatter_s"] for j in run.jobs if "scatter_s" in j["stats"]]
    return sum(vals) / len(vals) if vals else None
