"""Seconds from the start of the process to the first timed call: imports,
CUDA start-up, the port's libraries (built on a checkout's first run),
the corpus, and one warm-up request of each of the cell's shapes."""


def read(run):
    return run.setup_s
