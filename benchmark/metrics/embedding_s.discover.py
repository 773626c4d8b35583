"""embedding_s.discover: seconds a discover() run in its PCA embedding: the
fit (``timings_s["embedding_fit"]``: the scaler, the covariance on the
device, the eigensolve on the host) and the projection of every segment's
frames, ending in the features on the host (``timings_s["embedding_encode"]``),
the mean over the traced runs.  None where a run has neither span (an AE
run)."""

KEYS = ("embedding_fit", "embedding_encode")


def read(run):
    vals = [sum(j["stats"]["timings_s"].get(k, 0.0) for k in KEYS) for j in run.jobs
            if any(k in j["stats"]["timings_s"] for k in KEYS)]
    return sum(vals) / len(vals) if vals else None
