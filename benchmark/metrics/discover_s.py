"""discover_s: seconds per discover() run, the window from its start to the
last run that ended in it, over those runs."""


def read(run):
    return run.window_s / len(run.jobs)
