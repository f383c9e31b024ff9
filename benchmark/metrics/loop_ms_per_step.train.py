"""Host ms a step of the traced training epoch outside the batch draw, the
step and the waits on the device: the loop's own work (fetch, watchdog,
flush, structure logging and what no span names)."""
from benchmark import spans


def read(run):
    return spans.outside_ms_per_step(run, "train",
                                     ("train.batch", "train.step"))
