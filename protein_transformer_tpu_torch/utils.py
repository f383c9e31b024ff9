"""Framework utilities: the profiling hook.

Port of protein_transformer_tpu/utils.py. Its ``enable_compilation_cache``
has no counterpart: the port compiles no step, and its one persistent cache,
of the hand-written kernels, is ``ops/_build.py``'s directory of libraries
named by the hash of their sources.
"""
from __future__ import annotations

import contextlib
import os

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def maybe_profile(profile_dir: str | None):
    """A torch.profiler trace of the block (CPU operations, and the CUDA
    kernels when a GPU is present) written as a Chrome trace to
    ``<profile_dir>/trace.json`` when a directory is given; nothing
    otherwise."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))
