"""Adam's least bytes a step at the HBM bandwidth over the optimizer
category's device time a step, in %."""
from benchmark import readers
from benchmark.frozen import flops as F


def read(run):
    sec = readers.category_seconds(run, "optimizer")
    if run.kind != "train" or not sec:
        return None
    bound = F.adam_bytes(run.n_params) / F.HBM_BYTES_PER_S
    return 100.0 * bound * run.traced["rec"].steps / sec
