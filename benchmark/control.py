"""The readings that a cell's limits are set from: the program's numbers on
many seeds, and the control's and a planted fault's on a few.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 ... \\
        --control-seeds 1 2 3 [--out chiprun_out/control_<cell>.jsonl]

For each seed it makes the run's set-up (the first steps of a training
cell, one scoring epoch of a scoring cell: the same calls, feed and sizes
as the timed path) and prints the numbers of ``correct.py`` for the
program against the reference. On each control seed it also puts the
reference in the program's place twice: computed with TF32 on (the
precision just below the configuration's float32 with TF32 off: the
control), and with half of each batch's proteins left out, the mean taken
over the rest (a fault). The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--root", default=".")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from benchmark import harness as H
    from benchmark import spec
    cell = spec.load(args.root, args.workload)
    device = torch.device("cuda", 0) if args.device == "cuda" else \
        torch.device("cpu")
    H.set_precision(cell.config)
    lines = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        s = H.setup(cell, seed, device, warm=False)
        rec = s.warm_outputs
        H.free_program(s)
        variants = ("program",) + (("tf32", "half") if seed in
                                   args.control_seeds else ())
        if seed not in args.seeds:
            variants = variants[1:]
        if cell.traffic["loop"] == "train":
            got = H.train_check(s, variants)
        else:
            got = H.eval_check(s, rec, variants)
        line = {"workload": cell.name, "seed": seed,
                "seconds": time.perf_counter() - t0, **got}
        lines.append(line)
        print(json.dumps(line), flush=True)
        del s
        H.gc.collect()
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
