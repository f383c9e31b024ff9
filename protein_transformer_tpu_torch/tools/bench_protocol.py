"""Cross-run protocol of the port's bench: N fresh-process runs.

The counterpart of the JAX package's ``tools/bench_protocol.py``. Within
one run the paired windows pin the p50 and p95; what they cannot see is the
spread between processes (the kernels' build, the host's load, the card's
clocks). Protocol:

  1. every run is a fresh ``python -m protein_transformer_tpu_torch.bench``
     process (BENCH_MODE raw or trainer, BENCH_STEPS ``--steps``), with a
     timeout (600 s raw, 1200 s trainer, or ``--per_run_timeout``) and one
     retry; a run that fails or times out prints its event line, and a run
     that fails every attempt raises;
  2. run 0 is flagged ``"cold": true`` and left out of the median when the
     kernels' build directory (``ops/_build.py::BUILD_DIR``) held no built
     library before it: that run paid for the nvcc builds. The tool never
     deletes the directory;
  3. the headline is the median of the remaining runs' p50s (their values
     when a run prints no p50, as the trainer mode does), with its spread.

    python -m protein_transformer_tpu_torch.tools.bench_protocol \\
        [--runs 3] [--steps 30] [--mode raw|trainer] [--per_run_timeout S]

Each run's row is printed as it ends; the last line is the summary, with
the JAX tool's keys. It needs a GPU and raises without one.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.ops import _build

ROOT = str(Path(__file__).resolve().parents[2])
TIMEOUTS = {"raw": 600.0, "trainer": 1200.0}


def is_cold() -> bool:
    """Whether the kernels' build directory holds no built library."""
    return not any(Path(_build.BUILD_DIR).glob("lib*.so"))


def run_once(mode: str, steps: int, timeout: float,
             retries: int = 1) -> dict:
    """One fresh-process run of the bench: its JSON line, with ``p50_ms``
    and ``mfu_pct`` from its stderr where it prints them."""
    env = dict(os.environ, BENCH_STEPS=str(steps))
    env.pop("BENCH_MODE", None)
    if mode == "trainer":
        env["BENCH_MODE"] = "trainer"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    for attempt in range(retries + 1):
        try:
            p = subprocess.run(
                [sys.executable, "-m", "protein_transformer_tpu_torch.bench"],
                capture_output=True, text=True, env=env, cwd=ROOT,
                timeout=timeout)
        except subprocess.TimeoutExpired:
            print(json.dumps({"event": "run_timeout", "attempt": attempt,
                              "timeout_s": timeout}), flush=True)
            continue
        if p.returncode == 0:
            break
        print(json.dumps({"event": "run_failed", "attempt": attempt,
                          "stderr_tail": p.stderr[-500:]}), flush=True)
    else:
        raise RuntimeError(f"the bench failed {retries + 1} times")
    row = json.loads([ln for ln in p.stdout.splitlines()
                      if ln.startswith("{")][-1])
    m = re.search(r"p50: ([\d.]+) ms", p.stderr)
    if m:
        row["p50_ms"] = float(m.group(1))
    m = re.search(r"MFU ([\d.]+)%", p.stderr)
    if m:
        row["mfu_pct"] = float(m.group(1))
    return row


def summary(rows: list, cold: bool) -> dict:
    """The protocol's last line from the runs' rows: the median of the warm
    runs' p50s (or values) and their spread, as the JAX tool computes
    them."""
    kept = [r for r in rows if not r["cold"]]
    if not kept:
        raise RuntimeError("no warm run: the only run was cold; ask for "
                           "--runs 2 or more")
    key = "p50_ms" if all("p50_ms" in r for r in kept) else "value"
    vals = sorted(r[key] for r in kept)
    med = vals[len(vals) // 2]
    return {
        "protocol": f"median of {len(kept)} fresh-process runs"
                    + (" (cold run 0 discarded)" if cold else ""),
        "metric": key,
        "median": med,
        "spread": [vals[0], vals[-1]],
        "spread_pct": round(100 * (vals[-1] - vals[0]) / med, 2),
        "throughput_median": sorted(r["value"] for r in kept)[len(kept) // 2],
        "warm_cache": not cold,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--mode", default="raw", choices=sorted(TIMEOUTS))
    ap.add_argument("--per_run_timeout", type=float, default=None,
                    help="seconds per fresh-process run (default 600 raw / "
                         "1200 trainer)")
    args = ap.parse_args(argv)
    cuda_device()  # raises without a GPU
    timeout = args.per_run_timeout or TIMEOUTS[args.mode]
    cold = is_cold()
    rows = []
    for i in range(args.runs):
        row = run_once(args.mode, args.steps, timeout)
        row["run"] = i
        row["cold"] = cold and i == 0
        print(json.dumps(row), flush=True)
        rows.append(row)
    out = summary(rows, cold)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
