"""Host ms a step in the optimizer update of the traced training epoch
(``train.optimizer``)."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(run, "train", "train.optimizer")
