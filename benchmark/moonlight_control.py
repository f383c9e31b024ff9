"""The control and the fault readings of an 'mla-moe' cell's limits, where
``control.py``'s TF32 control does not apply (TF32 lies above the
configuration's bf16):

    python3 -m benchmark.moonlight_control --workload <cell> --seeds 1 2 3 \\
        [--out control_<cell>.jsonl]

For each seed it makes the run's set-up (the first steps of the training
cell, as the timed path takes them), then puts the reference in the
program's place twice against the reference itself: computed with every
trunk product's inputs rounded to float8 e4m3 (``fp8=True``: the
precision just below bf16, the control), and with half of each batch's
proteins left out (the fault). It prints ``correct.py``'s numbers of both.
The lower readings come from ``python3 -m benchmark.control``.
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
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--root", default=".")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from benchmark import correct
    from benchmark import harness as H
    from benchmark import spec
    cell = spec.load(args.root, args.workload)
    device = torch.device("cuda", 0) if args.device == "cuda" else \
        torch.device("cpu")
    H.set_precision(cell.config)
    conf, R = cell.config, cell.reference()
    for seed in args.seeds:
        t0 = time.perf_counter()
        s = H.setup(cell, seed, device, warm=False)
        H.free_program(s)
        batches = [R.batch_of(s.splits["train"], idx, shape[0], shape[1],
                              conf["pad_id"], device)
                   for idx, shape, _ in s.probe.first]
        w0 = cell.weights().make(conf, seed, H._angle_means(s), device)
        del s  # the probe's captures of the program's steps
        H.gc.collect()
        run_seed = cell.traffic["run_seed"]
        ref = R.train_steps(conf, w0, batches, run_seed, device)
        line = {"workload": cell.name, "seed": seed}
        for name, kw in (("fp8", {"fp8": True}), ("half",
                                                  {"drop_half": True})):
            got = R.train_steps(conf, w0, batches, run_seed, device, **kw)
            line[name] = correct.train_numbers(got, ref)
            del got
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del ref, w0
        H.gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
