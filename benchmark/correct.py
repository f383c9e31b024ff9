"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each held to its limit in ``benchmark/limits/``.

Training (the first steps of the run, through the window's own call and
feed): ``loss_gap``, the largest relative gap of a step's loss;
``grad_gap``, the worst leaf's gap between the program's and the
reference's norms of the first gradient as the optimizer takes it;
``change_gap``, the same of each parameter's change over the steps. A
leaf's gap is measured against the reference's norm of that leaf or of the
median leaf, whichever is larger. Leaves whose reference gradient is under
a thousandth of the median leaf's (nought to rounding, as a key bias under
softmax) are left out of both.

Scoring (a sample of the window's batches): the largest relative gap of
the loss, of the three angle MSEs, of the four dRMSD statistics and of the
superposition RMSD.
"""
from __future__ import annotations

import math

import torch

NEGLIGIBLE = 1e-3
EVAL_FAMILIES = {"loss_gap": ("loss", "combined-full"),
                 "mse_gap": ("mse-full", "mse-bb", "mse-sc"),
                 "drmsd_gap": ("drmsd-full", "lndrmsd-full", "drmsd-bb",
                               "lndrmsd-bb"),
                 "rmsd_gap": ("rmsd-full",)}


def _rel(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _median(values) -> float:
    v = sorted(values)
    return 0.5 * (v[(len(v) - 1) // 2] + v[len(v) // 2])


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    pn, rn = _norms({k: prog[k] for k in keep}), _norms({k: ref[k]
                                                       for k in keep})
    med = _median(rn.values())
    gaps = [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep]
    return max((g if math.isfinite(g) else math.inf for g in gaps),
               default=math.inf)


def train_numbers(prog, ref) -> dict:
    """``prog`` and ``ref``: readings with ``losses``, ``grad1`` and
    ``change`` (``reference.train.TrainReadings``)."""
    gref = _norms(ref.grad1)
    med = _median(gref.values())
    keep = [k for k, n in gref.items() if n >= NEGLIGIBLE * med]
    return {"loss_gap": max(_rel(a, b) for a, b in zip(prog.losses,
                                                      ref.losses)),
            "grad_gap": _leaf_gap(prog.grad1, ref.grad1, keep),
            "change_gap": _leaf_gap(prog.change, ref.change, keep)}


def eval_numbers(prog_rows: list, ref_rows: list, keys) -> dict:
    """Rows of metric values (``keys`` order), one per sampled batch."""
    out = {}
    for name, members in EVAL_FAMILIES.items():
        cols = [keys.index(m) for m in members]
        out[name] = max(_rel(p[c], r[c]) for p, r in zip(prog_rows, ref_rows)
                        for c in cols)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {value, limit}})."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
