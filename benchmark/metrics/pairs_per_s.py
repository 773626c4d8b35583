"""pairs_per_s: DTW pairs with a distance in D, over the jobs that ended in
the window, per second from the window's start to the last such job's end."""


def read(run):
    return sum(j["work"] for j in run.jobs) / run.window_s
