"""dtw_long_roofline.discover: K8's share of its roofline in a discover()
run, in %: the jobs' least time over K8's device time in the traced jobs.
A job's least time is ``benchmark.roofline.job_bound_s`` over its segment
lengths (``stats["lengths"]``), its feature width (``counts["feature_dim"]``)
and the configuration's band and ``max_seq_len``: the DP cells of every
pair at (3d+4) fp32 operations each over 67 TFLOP/s, or the features read
once and D written once over 3.35 TB/s.  K8's device time is the sum of the
trace's ``device_ops`` (its ten longest operations) whose names hold
``long_block_kernel``.  None without a trace, or where no K8 kernel ran (the
CPU's plain twin, a job routed elsewhere)."""

import numpy as np

from benchmark.roofline import job_bound_s

KERNEL = "long_block_kernel"


def read(run):
    if not run.trace:
        return None
    k8_s = sum(s for name, s in run.trace["device_ops"] if KERNEL in name)
    if k8_s <= 0 or not all("lengths" in j["stats"] for j in run.jobs):
        return None
    from benchmark.traffic.discover import pipeline_config

    dtw = pipeline_config(run.ctx).dtw
    kind = "full" if dtw.band is None else dtw.band_mode
    least = sum(job_bound_s(np.asarray(j["stats"]["lengths"]), dtw.max_seq_len,
                            int(j["stats"]["counts"]["feature_dim"]), kind, dtw.band)
                for j in run.jobs)
    return 100.0 * least / k8_s
