"""setup_s: seconds from the process's start to the first timed call."""


def read(run):
    return run.setup_s
