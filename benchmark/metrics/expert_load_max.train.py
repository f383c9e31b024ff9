"""The busiest expert's routed real residues over the mean (k x residues /
experts), from the program's counters ``moe.load.<layer>`` (routed real
residues per expert, one entry a layer a step), averaged over the expert
layers and the traced epoch's steps."""
from benchmark import spans

PREFIX = "moe.load."


def read(run):
    s = spans.session(run, "train")
    if s is None:
        return None
    ratios = [max(v) / (sum(v) / len(v))
              for name, c in s.get("counters", {}).items()
              if name.startswith(PREFIX) for v in c["values"] if sum(v) > 0]
    return sum(ratios) / len(ratios) if ratios else None
