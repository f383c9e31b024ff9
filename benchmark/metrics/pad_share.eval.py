"""Padded share of the scoring window's batch slots (data path)."""
from benchmark import readers


def read(run):
    return readers.pad_share(run, "eval")
