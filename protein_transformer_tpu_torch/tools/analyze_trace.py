"""Device time of a ``torch.profiler`` Chrome trace, by op or by source.

The port's counterpart of the JAX package's ``tools/analyze_trace.py``. It
reads the Chrome trace that ``torch.profiler`` exports (``trace.json``,
plain or gzipped; ``tools/trace_ladder.py``, ``--profile_dir``) and sums
the device events: kernels, copies and fills (the ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` categories).

* ``--by op``: device time by event name, template arguments and instance
  suffixes stripped: total ms, share, count, and a TOTAL line.
* ``--by source``: device ms a step (over ``--steps``) by category
  (``CATEGORIES``): each hand-written kernel by its symbol in ``csrc/``,
  the optimizer and the NeRF by where their launching operation was
  called from, then GEMMs, convolutions, copies, elementwise and reduction
  kernels, and the rest; each device event falls in exactly one. A kernel
  links to the CPU operation that launched it through the trace's
  correlation id, and an operation of the backward pass to the forward
  operation that recorded it through the ``fwdbwd`` flow, so a backward
  kernel counts where its forward operation was called from. Then the
  device ms a step by the innermost frame of this package on the launching
  stack, the device's idle share over the traced window, and its five
  longest idle gaps, each with the innermost of the program's spans
  (``tracing``: the trace's ``user_annotation`` ranges) that the host was
  in at its midpoint, which a trace without Python stacks holds too.

    python -m protein_transformer_tpu_torch.tools.analyze_trace \\
        <trace file or directory> [--by op|source] [--steps N] [--top 25]

Reads a file; needs neither a GPU nor the run that wrote it.
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re

from protein_transformer_tpu_torch.utils import TRACE_FILE

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the host events that nest on a thread: where a launch was called from
HOST_CATS = ("cpu_op", "python_function", "cuda_runtime", "cuda_driver",
             "user_annotation")
PACKAGE = "protein_transformer_tpu_torch/"
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


def find_trace(path: str) -> str:
    """``path`` if it is a file; in a directory its ``trace.json`` (or
    ``.gz``), else the newest ``*.json`` or ``*.json.gz`` under it."""
    if os.path.isfile(path):
        return path
    for name in (TRACE_FILE, TRACE_FILE + ".gz"):
        if os.path.isfile(os.path.join(path, name)):
            return os.path.join(path, name)
    found = [p for pattern in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(path, "**", pattern),
                                recursive=True)]
    if not found:
        raise FileNotFoundError(f"no Chrome trace under {path}")
    return max(found, key=os.path.getmtime)


def load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def device_events(events) -> list:
    return [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in DEVICE_CATS]


def base_name(name: str) -> str:
    """An event's name without ``void``, template arguments, parameters
    or an instance suffix."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)",
                                                "{anonymous}")
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif ch == "(" and not depth and out:
            break
        elif not depth:
            out.append(ch)
    return re.sub(r"\.\d+$", "", "".join(out).strip())


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


def source_of(frames: list[str]) -> str:
    """The innermost frame of this package, without its path's prefix."""
    for frame in frames:
        if PACKAGE in frame:
            return frame.split(PACKAGE, 1)[1]
    return "(outside the package)"


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


def by_op(events) -> dict:
    """{base name: [total us, count]} of the device events."""
    agg = collections.defaultdict(lambda: [0.0, 0])
    for e in device_events(events):
        row = agg[base_name(e.get("name", "?"))]
        row[0] += e["dur"]
        row[1] += 1
    return dict(agg)


def by_source(events, steps: int = 1) -> dict:
    """Device ms and events a step by category and by the innermost frame
    of this package, the total, and the idle share and longest gaps of the
    traced window."""
    evs = device_events(events)
    links = Launches(events)
    cats = {c: {"ms": 0.0, "count": 0} for c, _, _ in CATEGORIES}
    sources = collections.defaultdict(float)
    for e in evs:
        frames = links.stack_of(e)
        row = cats[category_of(e.get("name", ""), frames)]
        row["ms"] += e["dur"] / 1e3 / steps
        row["count"] += 1
        sources[source_of(frames)] += e["dur"] / 1e3 / steps
    for row in cats.values():
        row["count"] /= steps
    busy, window, gaps = busy_and_gaps(evs)
    linked = sum(links.launch_of(e) is not None for e in evs)
    return {"steps": steps, "categories": cats, "sources": dict(sources),
            "total_ms": sum(e["dur"] for e in evs) / 1e3 / steps,
            "device_events": len(evs) / steps,
            "linked_share": linked / len(evs) if evs else None,
            "window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window if window else None,
            "gaps_ms": [(g / 1e3, at / 1e3) for g, at in gaps[:5]],
            "gap_spans": gap_spans(events, evs, gaps[:5])}


def gap_spans(events, evs, gaps) -> list:
    """[(gap ms, start offset ms, span)] of idle gaps of the device events
    ``evs``: the innermost of the program's spans (``tracing``; the trace's
    ``user_annotation`` ranges) open on the host at each gap's midpoint, or
    "(no span)". Needs no Python stacks in the trace."""
    if not evs:
        return []
    origin = min(e["ts"] for e in evs)
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("ph") == "X" and "dur" in e]
    out = []
    for g, at in gaps:
        mid = origin + at + g / 2
        inner = min((e for e in ranges
                     if e["ts"] <= mid <= e["ts"] + e["dur"]),
                    key=lambda e: e["dur"], default=None)
        out.append((g / 1e3, at / 1e3,
                    inner["name"] if inner else "(no span)"))
    return out


def print_by_op(agg: dict, top: int = 25) -> None:
    total = sum(us for us, _ in agg.values())
    print(f"{'op':55s} {'total_ms':>10s} {'%':>6s} {'count':>7s}")
    for name, (us, n) in sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"{name[:55]:55s} {us / 1e3:10.3f} "
              f"{100 * us / max(total, 1e-9):6.1f} {n:7d}")
    print(f"{'TOTAL (device events)':55s} {total / 1e3:10.3f}")


def print_by_source(res: dict, top: int = 25) -> None:
    steps, total = res["steps"], res["total_ms"]
    print(f"== device time by category (ms/step over {steps} steps) ==")
    for cat, row in sorted(res["categories"].items(),
                           key=lambda kv: -kv[1]["ms"]):
        if row["count"]:
            print(f"{cat[:32]:32s} {row['ms']:9.3f} ms "
                  f"{100 * row['ms'] / max(total, 1e-9):5.1f}% "
                  f"n/step={row['count']:8.1f}")
    print(f"{'TOTAL':32s} {total:9.3f} ms n/step={res['device_events']:8.1f}")
    if res["linked_share"] is not None:
        print(f"{100 * res['linked_share']:.2f}% of the device events linked "
              f"to the operation that launched them")
    print("\n== device time by source frame (ms/step) ==")
    for src, ms in sorted(res["sources"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"{ms:9.3f} ms  {src[:90]}")
    if res["idle_share"] is not None:
        print(f"\nidle share {res['idle_share']:.4f} of the traced window "
              f"({res['window_ms']:.3f} ms, {res['busy_ms']:.3f} busy); "
              f"longest idle gaps: " + ", ".join(
                  f"{g:.3f} ms at +{at:.3f}" for g, at in res["gaps_ms"]))
        print("longest idle gaps by the span the host was in: " + ", ".join(
            f"{g:.3f} ms in {name}" for g, _, name in res["gap_spans"]))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trace", help="a Chrome trace, or a directory holding one")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--by", choices=["op", "source"], default="op")
    p.add_argument("--steps", type=int, default=1,
                   help="steps in the traced window (per-step division)")
    args = p.parse_args(argv)
    path = find_trace(args.trace)
    events = load_events(path)
    print(f"# {path}")
    if args.by == "source":
        res = by_source(events, args.steps)
        print_by_source(res, args.top)
        return res
    agg = by_op(events)
    print_by_op(agg, args.top)
    return {"ops": agg}


if __name__ == "__main__":
    main()
