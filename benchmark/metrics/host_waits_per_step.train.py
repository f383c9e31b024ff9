"""Blocking waits of the host on the device (``wait:`` spans) a step in
the traced training epoch."""
from benchmark import spans


def read(run):
    return spans.waits_per_step(run, "train")
