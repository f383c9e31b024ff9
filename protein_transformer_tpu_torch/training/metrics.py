"""Metrics accounting and CSV logging (reference: log.py:115-495); the
port's own copy of protein_transformer_tpu/training/metrics.py.

Same metric names and semantics as the reference's in-memory metrics dict:
per-mode ``batch-*`` / ``epoch-*`` values for drmsd/lndrmsd/mse (full, bb,
sc), combined, rmsd, residues/sec speed, per-epoch histories; CSV rows in the
reference's column order (log.py:488-495: drmsd, ln_drmsd, rmse, rmsd,
[combined], lr, mode, granularity, time, speed). MSE is recorded as MSE and
reported as RMSE (log.py:1-4). wandb logging is optional and isolated here.
"""
from __future__ import annotations

import csv
import time
from typing import Optional

import numpy as np

LOSS_KEYS = ("drmsd-full", "lndrmsd-full", "mse-full", "combined-full",
             "rmsd-full", "drmsd-bb", "lndrmsd-bb", "mse-bb", "mse-sc")


def init_metrics(modes) -> dict:
    # improvement/early-stop tracking lives in training.optim's
    # EarlyStopping/PlateauState machines, not here
    metrics = {
        "history-lr": [0.0],
        "last_chkpt_time": time.time(),
        "n_batches": 0,
    }
    for mode in modes:
        metrics[mode] = {"epoch-history-drmsd": [],
                         "epoch-history-combined": [],
                         "epoch-history-lndrmsd": [],
                         "epoch-history-mse": []}
    return metrics


def reset_for_epoch(metrics: dict, mode: str) -> dict:
    m = metrics[mode]
    for key in LOSS_KEYS:
        m[f"epoch-{key}"] = 0.0
        m[f"batch-{key}"] = 0.0
    m["batch-time"] = time.time()
    m["speed-history"] = []
    m["speed"] = 0.0
    metrics["n_batches"] = 0
    return metrics


def update_batch(metrics: dict, mode: str, losses: dict, n_res: int,
                 now: Optional[float] = None) -> dict:
    """Record one batch's losses (update_metrics, log.py:388-436).

    now: timestamp to use for the residues/sec statistic; the trainer
    passes each step's DISPATCH time so that batching the device->host
    metric fetches (which arrive in bursts) doesn't distort speeds."""
    m = metrics[mode]
    metrics["n_batches"] += 1
    for key in LOSS_KEYS:
        val = float(losses.get(key, 0.0) or 0.0)
        m[f"batch-{key}"] = val
        if key in ("drmsd-bb", "lndrmsd-bb", "mse-bb", "mse-sc"):
            # bug-compatible with the reference: bb/sc epoch values are
            # overwritten each batch (log.py:414-421) and then still divided
            # by n_batches at epoch end (log.py:468-471), so the logged epoch
            # value is last-batch/n -- reproduced exactly for comparability.
            m[f"epoch-{key}"] = val
        else:
            m[f"epoch-{key}"] += val
    now = time.time() if now is None else now
    m["speed"] = n_res / max(now - m["batch-time"], 1e-9)
    m["batch-time"] = now
    m["speed-history"].append(m["speed"])
    return metrics


def end_of_epoch(metrics: dict, mode: str) -> dict:
    """Average accumulated metrics (update_metrics_end_of_epoch,
    log.py:439-466)."""
    m = metrics[mode]
    n = max(metrics["n_batches"], 1)
    for key in ("drmsd-full", "lndrmsd-full", "mse-full", "rmsd-full",
                "drmsd-bb", "lndrmsd-bb", "mse-bb", "mse-sc"):
        m[f"epoch-{key}"] /= n
    if m["epoch-drmsd-full"] == 0:
        m["epoch-combined-full"] = 0.0
    else:
        m["epoch-combined-full"] /= n
    m["epoch-history-combined"].append(m["epoch-combined-full"])
    m["epoch-history-drmsd"].append(m["epoch-drmsd-full"])
    m["epoch-history-mse"].append(m["epoch-mse-full"])
    m["epoch-history-lndrmsd"].append(m["epoch-lndrmsd-full"])
    return metrics


class CsvLogger:
    """The reference's .train CSV log (log.py:115-131,488-495)."""

    def __init__(self, path: str, loss: str, resume: bool = False):
        self.loss = loss
        mode = "a" if resume else "w"
        self._f = open(path, mode, buffering=1)
        self._writer = csv.writer(self._f)
        if not resume:
            if loss == "combined":
                self._f.write(
                    "drmsd,ln_drmsd,rmse,rmsd,combined,lr,mode,granularity,"
                    "time,speed\n")
            else:
                self._f.write(
                    "drmsd,ln_drmsd,rmse,rmsd,lr,mode,granularity,time,"
                    "speed\n")

    def log(self, metrics: dict, mode: str, start_time: float,
            end_of_epoch: bool = False):
        m = metrics[mode]
        be = "epoch" if end_of_epoch else "batch"
        row = [m.get(f"{be}-drmsd-full", 0.0),
               m.get(f"{be}-lndrmsd-full", 0.0),
               float(np.sqrt(m.get(f"{be}-mse-full", 0.0))),
               m.get(f"{be}-rmsd-full", 0.0)]
        if self.loss == "combined":
            row.append(m.get(f"{be}-combined-full", 0.0))
        # Deliberate deviation: the reference writes granularity="epoch" on
        # every row (log.py:130), which makes the column useless to its own
        # analysis tooling; we record the real granularity so epoch rows can
        # be selected (ptt_scripts/analyze.py relies on this).
        row += [metrics["history-lr"][-1], mode, be,
                round(time.time() - start_time, 4), m.get("speed", 0.0)]
        self._writer.writerow(row)

    def close(self):
        self._f.close()


class BatchStatus:
    """Live per-batch status line (the reference's tqdm bar,
    log.py:18-58; --cluster toggle, train.py:518-520).

    Renders an in-place carriage-return line with the running batch
    losses, LR (noam only, as in the reference) and mean residues/sec,
    throttled to a few updates per second so rendering never shows up in
    the step loop. Auto-enabled on interactive stderr; disabled by
    --cluster (limited-I/O HPC environments get plain epoch prints only)
    and on non-process-0 ranks. Because the trainer pipelines its metric
    fetches, the line trails the device by up to FLUSH_EVERY steps --
    same information as the reference's bar, window cadence.
    """

    def __init__(self, loss: str, lr_scheduling: str,
                 enabled: Optional[bool] = None, stream=None,
                 min_interval: float = 0.25):
        import sys as _sys
        self.stream = stream if stream is not None else _sys.stderr
        if enabled is None:
            enabled = bool(getattr(self.stream, "isatty", lambda: False)())
        self.enabled = enabled
        self.loss = loss
        self.lr_scheduling = lr_scheduling
        self.min_interval = min_interval
        self._last = 0.0
        self._width = 0

    def _emit(self, text: str) -> None:
        pad = max(self._width - len(text), 0)
        self.stream.write("\r" + text + " " * pad)
        self.stream.flush()
        self._width = len(text)

    def _throttled(self, force: bool) -> bool:
        now = time.time()
        if not force and now - self._last < self.min_interval:
            return True
        self._last = now
        return False

    def update_train(self, metrics: dict, force: bool = False) -> None:
        """print_train_batch_status (log.py:18-44) analogue."""
        if not self.enabled or self._throttled(force):
            return
        m = metrics["train"]
        lr = metrics["history-lr"][-1]
        lr_str = f", LR = {lr:.7f}" if self.lr_scheduling == "noam" else ""
        speed = (float(np.mean(m["speed-history"]))
                 if m.get("speed-history") else 0.0)
        self._emit(
            f"  - (Train) drmsd={m.get('batch-drmsd-full', 0.0):.2f}, "
            f"lndrmsd={m.get('batch-lndrmsd-full', 0.0):0.7f}, "
            f"rmse={np.sqrt(max(m.get('batch-mse-full', 0.0), 0.0)):.4f}, "
            f"c={m.get('batch-combined-full', 0.0):.2f}{lr_str}, "
            f"res/s={speed:.0f}")

    def update_eval(self, mode: str, metrics: dict,
                    force: bool = False) -> None:
        """print_eval_batch_status (log.py:47-58) analogue."""
        if not self.enabled or self._throttled(force):
            return
        m = metrics[mode]
        self._emit(
            f"  - (Eval-{mode}) "
            f"drmsd = {m.get('batch-drmsd-full', 0.0):.6f}, "
            f"rmse = {np.sqrt(max(m.get('batch-mse-full', 0.0), 0.0)):.6f}, "
            f"comb = {m.get('batch-combined-full', 0.0):.6f}")

    def clear(self) -> None:
        """Erase the live line so epoch-status prints start clean."""
        if not self.enabled or self._width == 0:
            return
        self.stream.write("\r" + " " * self._width + "\r")
        self.stream.flush()
        self._width = 0


def print_epoch_status(mode: str, metrics: dict, start: float):
    """End-of-epoch console line (print_end_of_epoch_status, log.py:62-88)."""
    m = metrics[mode]
    lr = metrics["history-lr"][-1]
    speed = float(np.mean(m["speed-history"])) if m["speed-history"] else 0.0
    print(f"  - ({mode.capitalize()})  drmsd: {m['epoch-drmsd-full']:6.3f}, "
          f"rmse: {np.sqrt(m['epoch-mse-full']):6.3f}, "
          f"rmsd: {m['epoch-rmsd-full']:6.3f}, "
          f"comb: {m['epoch-combined-full']:6.3f}, "
          f"elapse: {(time.time() - start) / 60:3.3f} min, "
          f"lr: {lr:5.2e}, res/sec = {speed:.0f}")
