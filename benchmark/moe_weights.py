"""The weights of a configuration whose experts are stacked: those of
``benchmark.weights``, with every (E, out, in) stack of experts' matrices
drawn at each matrix's own Xavier-uniform bound, sqrt(6 / (in + out)),
where ``weights.make`` would take the stack for a convolution (fan from
the trailing dims, a bound ~30 times too small at the published widths).
The same seed gives the same bits.
"""
from __future__ import annotations

from benchmark import weights as W


def make(spec: dict, seed: int, angle_means, device) -> dict:
    out = W.make(spec, seed, angle_means, device)
    for t in out.values():
        if t.dim() == 3:
            t.mul_(W.xavier_bound(tuple(t.shape[1:]))
                   / W.xavier_bound(tuple(t.shape)))
    return out
