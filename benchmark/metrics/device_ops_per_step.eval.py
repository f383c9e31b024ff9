"""Device operations a scoring step in the profiled epoch."""
from benchmark import readers


def read(run):
    return readers.device_ops_per_step(run, "eval")
