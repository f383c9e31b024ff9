"""The port's benchmark: one run of one cell, ending in one JSON line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout that holds ``BENCHMARK.json``. With
``--trace 0`` the line carries the cell's end-to-end metrics (``setup_s``
and its throughput and step-time metrics); with ``--trace 1`` its per-layer
metrics, each read by ``benchmark/metrics/<name>.py`` from the untraced
window and one profiled epoch after it, with the device's busy and window
seconds and a breakdown. Every run compares what the timed path produced
with the plain reference (``benchmark/reference/``) and prints each number
beside its limit, last on standard error and last in the line.

It exits with 2 and prints no result without as many CUDA devices as the
cell asks for, and with 3 if JAX, flax or the JAX package was loaded.
``--device cpu`` runs on the CPU for the benchmark's own tests (no device
figure); ``--root`` reads another directory's ``BENCHMARK.json``.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "protein_transformer_tpu")
CHECKOUT = Path(__file__).resolve().parents[1]


def process_age() -> float:
    """Seconds since this process started (from /proc), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"),
                   time.perf_counter() - T0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T0


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--root", default=".")
    return p.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    # the program's kernel caches stay inside the checkout, at fixed paths
    build = CHECKOUT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    from benchmark import spec
    cell = spec.load(args.root, args.workload)
    chips = int(cell.workload["chips"])
    if args.device == "cuda":
        if not torch.cuda.is_available():
            return fail("no CUDA device is available", 2)
        if torch.cuda.device_count() < chips:
            return fail(f"{cell.name} needs {chips} CUDA devices, "
                        f"{torch.cuda.device_count()} are visible", 2)
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    from benchmark import harness as H
    H.set_precision(cell.config)

    s = H.setup(cell, args.seed, device)
    setup_s = process_age()
    rec = H.stretch(s, args.seconds)
    traced = H.traced_epoch(s) if args.trace else None
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    n_params = sum(v.numel() for v in (
        s.state.params if s.state is not None else s.params).values())
    H.free_program(s)
    if cell.traffic["loop"] == "train":
        numbers = H.train_check(s)["program"]
    else:
        numbers = H.eval_check(s, rec)["program"]
    ok, checks = H.correct.judge(numbers, cell.limits)

    if args.trace:
        run = H.RunData(cell.config, cell.traffic["loop"], rec, traced,
                        n_params, torch.cuda.get_device_name(device)
                        if on_card else "cpu", on_card)
        metrics = {}
        for m in cell.per_layer():
            value = cell.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = H.end_to_end(cell, rec, setup_s)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": chips if on_card else 0, "memory_peak_bytes": peak}
    result = {"correct": ok, "attempted": rec.steps, "failed": 0,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        top = sorted(traced["categories"].items(), key=lambda kv: -kv[1][0])
        result["breakdown"] = {
            "device_ops": [[c, v[0]] for c, v in top[:10]],
            "idle_gaps": [[f, g] for f, g in traced["gaps"]]}
    result["checks"] = checks
    found = banned_modules()
    if found:
        return fail("the run loaded " + ", ".join(found), 3)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
