"""Host ms a step drawing the next batch in the traced training epoch:
the sampler, ``plan_batch`` and the store's gather (``train.batch``)."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(run, "train", "train.batch")
