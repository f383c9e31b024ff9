"""Model FLOP utilisation of the scoring window at real lengths."""
from benchmark import readers


def read(run):
    return readers.step_mfu(run, "eval")
