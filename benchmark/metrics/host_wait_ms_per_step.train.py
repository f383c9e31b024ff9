"""Host ms a step blocked on the device (``wait:`` spans) in the traced
training epoch."""
from benchmark import spans


def read(run):
    return spans.wait_ms_per_step(run, "train")
