"""extraction_s.discover: seconds a discover() run in medoids and alignment
paths (``timings_s["extraction"]``, ending in paths on the host), the mean
over the traced runs."""


def read(run):
    vals = [j["stats"]["timings_s"]["extraction"] for j in run.jobs
            if "extraction" in j["stats"]["timings_s"]]
    return sum(vals) / len(vals) if vals else None
