"""dtw_stage_s.discover: seconds a discover() run in its all-pairs DTW stage
(``timings_s["dtw"]``, ending in D as NumPy), the mean over the traced runs."""


def read(run):
    vals = [j["stats"]["timings_s"]["dtw"] for j in run.jobs if "dtw" in j["stats"]["timings_s"]]
    return sum(vals) / len(vals) if vals else None
