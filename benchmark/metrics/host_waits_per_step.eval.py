"""Blocking waits of the host on the device (``wait:`` spans) a batch in
the traced scoring epoch."""
from benchmark import spans


def read(run):
    return spans.waits_per_step(run, "eval")
