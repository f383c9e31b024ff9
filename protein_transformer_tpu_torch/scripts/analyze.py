"""Compare training runs: best and final epoch metrics from their CSV logs.

The port's counterpart of ptt_scripts/analyze.py (the reference's
scripts/analyze.py is an unfinished stub, :16-24): read each run's
``.train`` CSV (``training/metrics.py``'s ``CsvLogger``) and its
``config.json``, report the best and final epoch metrics of one mode, and
rank the runs.

Run: python -m protein_transformer_tpu_torch.scripts.analyze \
         <run_dir> [<run_dir> ...] [--mode train] [--metric rmse]
"""
from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

METRICS = ("drmsd", "ln_drmsd", "rmse", "rmsd", "combined")


def read_epoch_rows(train_csv: str, mode: str):
    """(header, {column: index}, the epoch rows of ``mode``)."""
    with open(train_csv) as f:
        reader = csv.reader(f)
        header = next(reader)
        cols = {name: i for i, name in enumerate(header)}
        rows = [r for r in reader
                if r and r[cols["mode"]] == mode
                and r[cols["granularity"]] == "epoch"]
    return header, cols, rows


def summarize_run(run_dir: str, mode: str) -> dict:
    """A run's name, epochs, model, width and loss, and the best and final
    value of each metric over its epochs of ``mode``."""
    name = os.path.basename(run_dir.rstrip("/"))
    csvs = [f for f in os.listdir(run_dir) if f.endswith(".train")]
    if not csvs:
        raise FileNotFoundError(f"no .train log in {run_dir}")
    _, cols, rows = read_epoch_rows(os.path.join(run_dir, csvs[0]), mode)
    out = {"run": name, "epochs": len(rows)}
    cfg_path = os.path.join(run_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)["config"]
        out["model"] = cfg.get("model")
        out["d_model"] = cfg.get("d_model")
        out["loss"] = cfg.get("loss")
    for m in METRICS:
        if m in cols and rows:
            vals = np.array([float(r[cols[m]]) for r in rows])
            out[f"best_{m}"] = float(vals.min())
            out[f"final_{m}"] = float(vals[-1])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("runs", nargs="+")
    p.add_argument("--mode", default="train")
    p.add_argument("--metric", default="rmse", choices=METRICS)
    args = p.parse_args(argv)
    summaries = [summarize_run(r, args.mode) for r in args.runs]
    key = f"best_{args.metric}"
    summaries.sort(key=lambda s: s.get(key, float("inf")))
    fields = ["run", "model", "d_model", "loss", "epochs",
              f"best_{args.metric}", f"final_{args.metric}"]
    print("  ".join(f"{f:>14s}" for f in fields))
    for s in summaries:
        print("  ".join(f"{str(s.get(f, '-'))[:14]:>14s}" for f in fields))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
