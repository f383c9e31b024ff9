"""What the readers of the program's spans share (``benchmark/metrics/*``
whose source is ``program_span`` and which read the port's ``tracing``).

The port records its spans only under a profiler (or its own switch, which
a benchmark run leaves unset), so after a ``--trace 1`` run
``tracing.last_session()`` holds the traced epoch's spans: the window's
epochs record nothing. Each reader divides by the session's count of
``train.step`` or ``eval.step`` spans, and returns None where the port has
no ``tracing`` module or the session is not of the run's loop; the harness
then leaves the metric out. The times are the profiled epoch's, whose host
runs slower than the window's.
"""
from __future__ import annotations

WAIT = "wait:"


def session(run, kind: str):
    """The traced epoch's session of ``kind`` ("train" or "eval"), or
    None."""
    if run.kind != kind or run.traced is None:
        return None
    try:
        from protein_transformer_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.last_session()
    if s is None or s["count"].get(f"{kind}.epoch") != 1 \
            or not s["count"].get(f"{kind}.step"):
        return None
    return s


def _steps(s, kind: str) -> int:
    return s["count"][f"{kind}.step"]


def ms_per_step(run, kind: str, name: str):
    """Host ms inside the spans named ``name``, a step."""
    s = session(run, kind)
    if s is None:
        return None
    return s["total_ms"].get(name, 0.0) / _steps(s, kind)


def wait_ms_per_step(run, kind: str):
    """Host ms inside ``wait:`` spans, a step."""
    s = session(run, kind)
    if s is None:
        return None
    return sum(ms for name, ms in s["total_ms"].items()
               if name.startswith(WAIT)) / _steps(s, kind)


def waits_per_step(run, kind: str):
    """``wait:`` spans (the program's blocking waits on the device), a
    step."""
    s = session(run, kind)
    if s is None:
        return None
    return sum(n for name, n in s["count"].items()
               if name.startswith(WAIT)) / _steps(s, kind)


def outside_ms_per_step(run, kind: str, names: tuple):
    """Host ms of the epoch span outside every span named in ``names`` or
    starting with ``wait:``, a step: each such span counts once, where no
    span of those encloses it."""
    s = session(run, kind)
    if s is None:
        return None
    spans = s["spans"]

    def taken(sp) -> bool:
        return sp["name"] in names or sp["name"].startswith(WAIT)

    def enclosed(sp) -> bool:
        p = sp["parent"]
        while p >= 0:
            if taken(spans[p]):
                return True
            p = spans[p]["parent"]
        return False

    inside = sum(sp["end_ns"] - sp["start_ns"] for sp in spans
                 if taken(sp) and not enclosed(sp))
    return (s["total_ms"][f"{kind}.epoch"] - inside / 1e6) / _steps(s, kind)
