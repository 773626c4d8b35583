"""ae_step_ms.discover: milliseconds an Adam step of a discover() run's AE
training: the steps' host span (``timings_s["autoencoder_train.steps"]``,
from the first step's enqueue to the losses on the host) over their number
(``counts["ae_steps"]``, epochs x batches), the mean over the traced runs.
None where the program records no such span."""

KEY = "autoencoder_train.steps"


def read(run):
    vals = [1e3 * j["stats"]["timings_s"][KEY] / j["stats"]["counts"]["ae_steps"]
            for j in run.jobs
            if KEY in j["stats"]["timings_s"] and j["stats"]["counts"].get("ae_steps")]
    return sum(vals) / len(vals) if vals else None
