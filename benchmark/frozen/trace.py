"""Device events of a ``torch.profiler`` Chrome trace, by category.

A frozen copy of ``protein_transformer_tpu_torch/tools/analyze_trace.py``
(its categoriser, the launch links and the idle-gap reader) at commit
026902350ad78ec8349700d5f0a9d57ffc236aec. Every device event (kernel, copy
or fill) falls in exactly one category (``CATEGORIES``): each hand-written
kernel by its symbol, the optimizer and the NeRF by where their launching
operation was called from (a backward operation counts where its forward
operation was called from), then GEMMs, convolutions, copies, elementwise
and reduction kernels, and the rest. ``busy_and_gaps`` gives the union of
the device-busy intervals and the idle gaps between them. ``traced`` (from
``tools/bench_drmsd_kernel.py`` at the same commit) takes a trace again
when it comes back without device events.
"""
from __future__ import annotations

import collections
import gzip
import json
import re

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the host events that nest on a thread: where a launch was called from
HOST_CATS = ("cpu_op", "python_function", "cuda_runtime", "cuda_driver",
             "user_annotation")
ENGINE_WRAPPER = "autograd::engine::evaluate_function: "

# The hand-written kernels, each by its symbol in csrc/ (K1a, K1b, K1c and
# K4a are instances of one template): (category, pattern of the name).
HAND_KERNELS = (
    ("K1a drmsd_fwd", r"k1_tile_kernel<false, true(, false)?>"),
    ("K1b drmsd_fwd_grad", r"k1_tile_kernel<true, true(, false)?>"),
    ("K1c drmsd_grad_b", r"k1_tile_kernel<true, false(, false)?>"),
    ("K4a drmsd_fwd_sqrt1", r"k1_tile_kernel<false, true, true>"),
    ("k1_epilogue_kernel", r"k1_epilogue_kernel"),
    ("K2a sidechain_fwd", r"sidechain_fwd_kernel"),
    ("K2b sidechain_bwd", r"sidechain_bwd_kernel"),
    ("K3a flash_attn_fwd", r"flash_attn_fwd_kernel"),
    ("flash_attn_bwd", r"flash_attn_bwd_kernel"),
    ("K3a-bf16 flash_attn_fwd_bf16", r"flash_attn_fwd_bf16_kernel"),
    ("flash_attn_bwd_bf16", r"flash_attn_bwd_bf16_kernel"),
    ("K4b drmsd_fwd_mxu", r"mxu_stat_tile_kernel"),
    ("K4c drmsd_grad_a_mxu", r"mxu_grad_tile_kernel"),
)
# (category, what the rule reads, pattern): the first rule whose pattern
# matches names a device event's category. "name" reads the event's name;
# "stack" the Python frames its launching operation was called from (for a
# backward operation, also those of its forward operation). The last rule
# matches every event.
CATEGORIES = tuple((c, "name", p) for c, p in HAND_KERNELS) + (
    ("optimizer", "stack", r"training/optim\.py"),
    ("NeRF", "stack", r"ops/nerf\.py|protein/geometry\.py"),
    ("convolution", "name",
     r"conv(?!ert)|cudnn|fprop|dgrad|wgrad|winograd|fft"),
    ("GEMM", "name", r"gemm|gemv|cutlass|cublas|xmma|splitKreduce"),
    ("copies", "name", r"^Memcpy|^Memset|copy|Copy"),
    ("elementwise and reduction", "name",
     r"at::native|elementwise|reduce|Reduce|softmax"),
    ("other", "name", r""),
)


def load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def device_events(events) -> list:
    return [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in DEVICE_CATS]


class Launches:
    """Where each device event was launched from: the host events of every
    thread nested by time, the runtime calls by correlation id, and the
    ``fwdbwd`` flows from a backward operation to its forward one."""

    def __init__(self, events):
        self.parent: dict[int, int | None] = {}
        self.events: dict[int, dict] = {}
        self.by_correlation: dict = {}
        self.cpu_op_at: dict = {}
        threads = collections.defaultdict(list)
        for e in events:
            if e.get("ph") == "X" and "dur" in e and e.get("cat") in HOST_CATS:
                threads[(e.get("pid"), e.get("tid"))].append(e)
        for evs in threads.values():
            evs.sort(key=lambda e: (e["ts"], -e["dur"]))
            stack: list[dict] = []
            for e in evs:
                end = e["ts"] + e["dur"]
                while stack and stack[-1]["ts"] + stack[-1]["dur"] < end - 1e-3:
                    stack.pop()
                self.parent[id(e)] = id(stack[-1]) if stack else None
                self.events[id(e)] = e
                stack.append(e)
                args = e.get("args", {})
                if e["cat"] in ("cuda_runtime", "cuda_driver") \
                        and "correlation" in args:
                    self.by_correlation[args["correlation"]] = e
                if e["cat"] == "cpu_op":
                    self.cpu_op_at[(e.get("pid"), e.get("tid"), e["ts"])] = e
        flows = collections.defaultdict(dict)
        for e in events:
            if e.get("cat") == "fwdbwd" and e.get("ph") in ("s", "f"):
                flows[e["id"]][e["ph"]] = (e.get("pid"), e.get("tid"),
                                           e["ts"])
        self.forward_of = {f["f"]: f["s"] for f in flows.values()
                           if "s" in f and "f" in f}
        # the engine's wrapper of a backward node (which also sums the
        # node's gradients into their buffers) carries no flow: it shares
        # its node's sequence number
        for at, e in self.cpu_op_at.items():
            if at in self.forward_of and "Sequence number" in e["args"]:
                self.forward_of.setdefault(
                    ("seq", e["args"]["Sequence number"]), self.forward_of[at])

    def ancestors(self, e) -> list:
        out, key = [], self.parent.get(id(e))
        while key is not None:
            out.append(self.events[key])
            key = self.parent[key]
        return out

    def frames(self, host_event, follow: bool = True) -> list[str]:
        """The Python frames (innermost first) that enclose a host event;
        for a backward operation those of its forward operation come
        first."""
        chain = [host_event] + self.ancestors(host_event)
        own = [e["name"] for e in chain if e["cat"] == "python_function"]
        if follow:
            for e in chain:
                fwd = self.forward_of.get((e.get("pid"), e.get("tid"),
                                           e["ts"]))
                if fwd is None and e["name"].startswith(ENGINE_WRAPPER):
                    fwd = self.forward_of.get(
                        ("seq", e["args"].get("Sequence number")))
                if fwd is not None and fwd in self.cpu_op_at:
                    return self.frames(self.cpu_op_at[fwd], False) + own
        return own

    def launch_of(self, device_event):
        """The runtime call that launched a device event, or None."""
        return self.by_correlation.get(
            device_event.get("args", {}).get("correlation"))

    def stack_of(self, device_event) -> list[str]:
        """The frames a device event was launched from ([] when the trace
        does not say)."""
        launch = self.launch_of(device_event)
        return self.frames(launch) if launch is not None else []


def category_of(name: str, frames: list[str]) -> str:
    stack = "\n".join(frames)
    for category, reads, pattern in CATEGORIES:
        if re.search(pattern, name if reads == "name" else stack,
                     re.M if reads == "stack" else 0):
            return category
    raise AssertionError("the last category matches every event")


def busy_and_gaps(evs) -> tuple[float, float, list]:
    """(busy us, window us, idle gaps [(us, start offset us)] longest
    first) of device events over the window they span."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs)
    if not spans:
        return 0.0, 0.0, []
    busy, gaps = 0.0, []
    start, end = spans[0]
    origin = start
    for s, t in spans[1:]:
        if s > end:
            busy += end - start
            gaps.append((s - end, end - origin))
            start, end = s, t
        else:
            end = max(end, t)
    busy += end - start
    return busy, end - origin, sorted(gaps, reverse=True)


def traced(fn, on_card: bool, **profile_kw):
    """(a profile of one fn() call, the traces taken). On the card it
    records the CPU and CUDA activities, and a trace that comes back
    without device records is taken again, up to three traces; off the
    card it records the CPU alone, once."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    for traces in range(1, 4):
        if on_card:
            torch.cuda.synchronize()
        with profile(activities=activities, **profile_kw) as prof:
            fn()
            if on_card:
                torch.cuda.synchronize()
        if not on_card or any(
                e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.key_averages()):
            return prof, traces
    raise RuntimeError("the profiler recorded no device operation")
