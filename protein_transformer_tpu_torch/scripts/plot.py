"""Training curves from a run's CSV ``.train`` log.

The port's counterpart of ptt_scripts/plot.py (the reference's
scripts/plot.py: drmsd / rmse / combined / ln_drmsd curves with optional
smoothing), reading the CSV that ``training/metrics.py``'s ``CsvLogger``
writes. It draws with matplotlib when it is installed, and otherwise
prints a text summary of each curve.

Run: python -m protein_transformer_tpu_torch.scripts.plot <run.train> \
         [--metric combined] [--mode train] [--out plot.png] [--smooth 21]
"""
from __future__ import annotations

import argparse
import csv
import sys

import numpy as np

METRICS = ("drmsd", "ln_drmsd", "rmse", "rmsd", "combined")


def read_log(path: str) -> dict:
    """{"mode": [...], "time": [...], metric: [...]} of every row."""
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    cols = {name: i for i, name in enumerate(header)}
    out = {"mode": [r[cols["mode"]] for r in rows],
           "time": [float(r[cols["time"]]) for r in rows]}
    for m in METRICS:
        if m in cols:
            out[m] = [float(r[cols[m]]) for r in rows]
    return out


def smooth(y, window: int = 21) -> np.ndarray:
    """A moving average over ``window`` points (``y`` itself when shorter)."""
    if len(y) < window:
        return np.asarray(y)
    kernel = np.ones(window) / window
    return np.convolve(y, kernel, mode="valid")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("log")
    p.add_argument("--metric", default=None, choices=METRICS)
    p.add_argument("--mode", default="train")
    p.add_argument("--out", default=None)
    p.add_argument("--smooth", type=int, default=21)
    args = p.parse_args(argv)

    log = read_log(args.log)
    metrics = [args.metric] if args.metric else [m for m in METRICS
                                                 if m in log]
    sel = [i for i, m in enumerate(log["mode"]) if m == args.mode]
    if not sel:
        print(f"no rows for mode {args.mode}", file=sys.stderr)
        return 1

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        for m in metrics:
            y = np.asarray(log[m])[sel]
            print(f"{args.mode} {m}: first={y[0]:.4f} last={y[-1]:.4f} "
                  f"min={y.min():.4f} n={len(y)}")
        return 0
    fig, axes = plt.subplots(len(metrics), 1,
                             figsize=(8, 2.5 * len(metrics)), squeeze=False)
    for ax, m in zip(axes[:, 0], metrics):
        y = np.asarray(log[m])[sel]
        ax.plot(y, alpha=0.3, label=m)
        ax.plot(np.arange(len(smooth(y, args.smooth))),
                smooth(y, args.smooth), label=f"{m} (smoothed)")
        ax.set_ylabel(m)
        ax.legend(loc="upper right", fontsize=8)
    axes[-1, 0].set_xlabel("batch")
    out = args.out or args.log + ".png"
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
