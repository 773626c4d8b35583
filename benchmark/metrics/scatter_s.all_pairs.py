"""scatter_s.all_pairs: seconds a job of the scheduler's host span around the
native scatter of each tile's distances into D (``stats["scatter_s"]``), the
mean over the traced jobs."""


def read(run):
    vals = [j["stats"]["scatter_s"] for j in run.jobs if "scatter_s" in j["stats"]]
    return sum(vals) / len(vals) if vals else None
