"""Spans: the program's own record of where its loops spend host time.

``span(name)`` names a stretch of host work of the training or scoring
loop (``train.step``, ``train.forward``, ``eval.batch``, ...), ``wait(site)``
one blocking wait of the host on the device (``wait:<site>``), and
``epoch(name)`` the outermost span of an epoch (``train.epoch``,
``eval.epoch``). Each is a context manager.

**When spans are live.** Inside a profiling session
(``torch.autograd._profiler_enabled()``: the benchmark's traced epoch,
``--profile_dir``), or with ``PTT_LOOP_PROFILE`` set in the environment
(read when an epoch span opens). Off, a span costs that one check and
returns a shared empty context: no clock read, no allocation, no
``record_function``.

**What a live span records.** Its name, its parent, the step it belongs
to (the "request id" the spans of one step share: given, or the parent's)
and its host start and end (``time.perf_counter_ns``). Under a profiler it
is also a ``torch.profiler.record_function`` range, so it lands in the
Chrome trace as a ``user_annotation`` on the host thread and a
``gpu_user_annotation`` over its kernels, on the clock of the device
events: an idle gap of the device can be put down to the innermost span
the host was in. Spans record no CUDA event and never synchronise; the
number of ``wait:`` spans is the program's count of its synchronisations.

**Sessions.** An epoch span opened with no span open begins a session,
which ends when it closes. Every profiler in this repository covers one
epoch (the benchmark's traced epoch and each retake of it,
``--profile_dir``'s first epoch), so there a session is one profiling
session, and a trace taken again leaves its own session newest; a
profiler over several epochs gives a session an epoch (seeing the
profiler start would cost the off path a second check). The recorder keeps the session
being recorded and the newest finished one; ``last_session()`` returns the
latter as plain host data. Spans opened outside a session are ranges in a
trace and nothing more.

Spans are opened on the loop's thread only.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

SWITCH = "PTT_LOOP_PROFILE"
WAIT = "wait:"

_profiling = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_switch = False
_open: list = []        # the live spans open now, innermost last
_recording = None       # the session being recorded: [name, parent, step,
                        # start ns, end ns] a span
_last = None            # the newest finished session, as last_session()
_sessions = 0           # sessions finished so far: the newest one's id


class _Span:
    __slots__ = ("name", "step", "root", "index", "range")

    def __init__(self, name: str, step, root: bool = False):
        self.name, self.step, self.root = name, step, root

    def __enter__(self):
        global _recording
        parent = _open[-1] if _open else None
        if self.step is None:
            self.step = parent.step if parent is not None else -1
        if self.root and parent is None:
            _recording = []
        self.range = None
        if _profiling():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        self.index = -1
        if _recording is not None:
            self.index = len(_recording)
            _recording.append([self.name, -1 if parent is None
                               else parent.index, self.step,
                               time.perf_counter_ns(), 0])
        _open.append(self)
        return self

    def __exit__(self, *exc):
        global _recording, _last, _sessions
        end = time.perf_counter_ns()
        _open.pop()
        if self.index >= 0:
            _recording[self.index][4] = end
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.root and not _open and _recording is not None:
            _sessions += 1
            _last, _recording = _session(_sessions, _recording), None
        return False


def _session(n: int, records: list) -> dict:
    total: dict = {}
    count: dict = {}
    for name, _, _, start, end in records:
        total[name] = total.get(name, 0.0) + (end - start) / 1e6
        count[name] = count.get(name, 0) + 1
    return {"id": n,
            "spans": [{"name": name, "parent": p, "step": step,
                       "start_ns": a, "end_ns": b}
                      for name, p, step, a, b in records],
            "total_ms": total, "count": count}


def span(name: str, step: int | None = None):
    """A span of host work; ``step`` by default its parent's."""
    if _switch or _profiling():
        return _Span(name, step)
    return _OFF


def wait(site: str, step: int | None = None):
    """A span around one blocking wait of the host on the device, named
    ``wait:<site>``."""
    if _switch or _profiling():
        return _Span(WAIT + site, step)
    return _OFF


def epoch(name: str, step: int | None = None):
    """The span of one epoch, which begins a session when no span is open;
    reads ``PTT_LOOP_PROFILE`` first."""
    global _switch
    _switch = bool(os.environ.get(SWITCH))
    if _switch or _profiling():
        return _Span(name, step, root=True)
    return _OFF


def switched_on() -> bool:
    """Whether ``PTT_LOOP_PROFILE`` was set when the last epoch began."""
    return _switch


def last_session() -> dict | None:
    """The newest finished session, or None:

    ``{"id": n, "spans": [{"name", "parent" (index, -1 for none), "step",
    "start_ns", "end_ns"}, ...], "total_ms": {name: host ms},
    "count": {name: spans}}``, the spans in the order they opened."""
    return _last
