"""Device milliseconds a training step in the NeRF category."""
from benchmark import readers


def read(run):
    sec = readers.category_seconds(run, "NeRF")
    if run.kind != "train" or sec is None:
        return None
    return 1e3 * sec / run.traced["rec"].steps
