"""What the per-layer metric readers (``benchmark/metrics/*.py``) share.

Each reader takes the run's ``harness.RunData`` and returns its number, or
None where the run gives it nothing to read (no trace, no device events,
no time in the category): the harness then leaves the metric out.
"""
from __future__ import annotations

from benchmark.frozen import flops as F


def pad_share(run, kind: str):
    """Padded slots (dummy rows and length padding) over all rows x length
    slots of the window's batches, in %."""
    s = run.stretch
    if run.kind != kind or not s.steps:
        return None
    slots = sum(r * n for r, n in s.shapes)
    return 100.0 * (slots - s.n_res) / slots


def device_ops_per_step(run, kind: str):
    t = run.traced
    if run.kind != kind or t is None or not t["n_events"]:
        return None
    return t["n_events"] / t["rec"].steps


def device_idle_share(run, kind: str):
    """1 - the union of device-busy intervals over the profiled epoch's
    wall seconds, in %."""
    t = run.traced
    if run.kind != kind or t is None or not t["n_events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def step_mfu(run, kind: str):
    """The frozen FLOP count at each protein's real length over the
    window's steps, over (the window's seconds x the bf16 dense peak), in
    %. Nothing recomputed counts."""
    s = run.stretch
    if run.kind != kind or not run.on_card or not s.steps \
            or len(s.lens) != s.steps:
        return None
    count = F.train_flops_real if kind == "train" else F.eval_flops_real
    flops = sum(count(run.config, lens) for lens in s.lens)
    return 100.0 * flops / (s.seconds * F.peak_bf16(run.device_name))


def category_seconds(run, category: str):
    t = run.traced
    if t is None or category not in t["categories"]:
        return None
    return t["categories"][category][0]


def roofline(run, category: str, forward_count):
    """A training step's operations of one kind at the padded shapes the
    kernels ran (three times the forward's), at the fp32 peak, over the
    category's device seconds, in %."""
    sec = category_seconds(run, category)
    if run.kind != "train" or not sec:
        return None
    ops = sum(3.0 * forward_count(run.config, r, n)
              for r, n in run.traced["rec"].shapes)
    return 100.0 * ops / F.PEAK_FP32 / sec
