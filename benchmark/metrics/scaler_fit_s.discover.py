"""scaler_fit_s.discover: seconds a discover() run in the AE's feature
scaler fit (``timings_s["autoencoder_train.scaler_fit"]``, NumPy on the
host), the mean over the traced runs.  None where the program records no
such span."""

KEY = "autoencoder_train.scaler_fit"


def read(run):
    vals = [j["stats"]["timings_s"][KEY] for j in run.jobs if KEY in j["stats"]["timings_s"]]
    return sum(vals) / len(vals) if vals else None
