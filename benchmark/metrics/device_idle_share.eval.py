"""The device's idle share of the profiled scoring epoch."""
from benchmark import readers


def read(run):
    return readers.device_idle_share(run, "eval")
