"""Framework utilities: the profiling hook.

Port of protein_transformer_tpu/utils.py. Its ``enable_compilation_cache``
has no counterpart: the port compiles no step, and its one persistent cache,
of the hand-written kernels, is ``ops/_build.py``'s directory of libraries
named by the hash of their sources.
"""
from __future__ import annotations

import contextlib
import json
import os

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"


@contextlib.contextmanager
def maybe_profile(profile_dir: str | None):
    """A torch.profiler trace of the block (CPU operations, and the CUDA
    kernels when a GPU is present) written as a Chrome trace to
    ``<profile_dir>/trace.json`` when a directory is given, and the spans
    of the session the block recorded (``tracing.last_session()``; none
    when it recorded none) to ``<profile_dir>/spans.json``; nothing
    otherwise."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    from protein_transformer_tpu_torch import tracing

    os.makedirs(profile_dir, exist_ok=True)
    before = tracing.last_session()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))
    session = tracing.last_session()
    with open(os.path.join(profile_dir, SPANS_FILE), "w") as f:
        json.dump(session if session is not before else
                  {"spans": [], "total_ms": {}, "count": {}}, f)
