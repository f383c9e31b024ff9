"""Host ms a batch drawing the next batch in the traced scoring epoch
(``eval.batch``)."""
from benchmark import spans


def read(run):
    return spans.ms_per_step(run, "eval", "eval.batch")
