"""Host ms a step in ``compute_losses`` (model, NeRF and sidechains,
losses) of the traced training epoch (``train.forward``)."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(run, "train", "train.forward")
