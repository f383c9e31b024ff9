"""Host ms a batch blocked on the device (``wait:`` spans) in the traced
scoring epoch."""
from benchmark import spans


def read(run):
    return spans.wait_ms_per_step(run, "eval")
