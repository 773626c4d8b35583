"""setup_s: seconds from the process's start to the end of the warm-up
(imports, the seed's data, the first job, which builds what it uses)."""


def read(run):
    return run.setup_s
