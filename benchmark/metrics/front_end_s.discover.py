"""front_end_s.discover: seconds a discover() run in ingest, spectrogram
and segmentation (``counters.timings_s``), the mean over the traced runs."""

STAGES = ("ingest", "spectrogram", "segmentation")


def read(run):
    vals = [sum(j["stats"]["timings_s"].get(s, 0.0) for s in STAGES) for j in run.jobs]
    return sum(vals) / len(vals) if vals else None
