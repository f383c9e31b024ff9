"""Host ms a step in ``torch.autograd.grad`` of the traced training epoch
(``train.backward``)."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(run, "train", "train.backward")
