"""The device's idle share of the profiled training epoch."""
from benchmark import readers


def read(run):
    return readers.device_idle_share(run, "train")
