"""Config-ladder train-step benchmark (BASELINE.md's ladder) on one GPU.

The port's counterpart of the JAX package's ``tools/bench_ladder.py``, with
its five configurations, arguments and output keys. It times the raw
training step (``Trainer.train_step`` on one batch collated by hand and
moved to the card once) of the ladder entries that exercise distinct
regimes:

  1. enc-only dm=64 nl=2, mse            (B=8, L=64)   -- tiny
  2. conv-enc dm=256, mse + noam          (B=8, L=256)  -- conv front-end
  3. enc-only dm=256, drmsd               (B=8, L=256)  -- NeRF in-step
  4. conv-enc dm=512 nl=6, combined       (B=8, L=256)  -- flagship
  5. conv-enc dm=1024, lndrmsd+backbone   (B=4, L=500)  -- the ladder's top

The step time comes from paired windows: eight repeats of a k-step and a
2k-step window, each ending in one ``torch.cuda.synchronize()``;
(T2 - T1) / k cancels the fixed cost of a window's synchronisation. The
host's time moves by +-30% between runs on one card, so each line also
carries what repeats: the device operations and device ms of a step and
the device's idle share (a ``torch.profiler`` trace of three steps against
the median step), and the stream synchronisations of one step. TF32 is
off, for matrix products and cuDNN alike.

    python -m protein_transformer_tpu_torch.tools.bench_ladder \\
        [--configs 1 3 4 5] [--steps 30] [--dtype bfloat16] [--max-batch]

``--max-batch`` benches at 0.8x the card's memory frontier: a subprocess
probes it (``--probe-only``, which prints ``MAXB=<n>``) and the batch steps
down to the collate lattice. ``--device cpu`` runs the steps on the CPU for
the tests (no device figure, no MFU); without it the tool needs a GPU and
raises when there is none.

Prints one JSON line per configuration.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.dataset import (
    bucket_batch_size, collate)
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.tools.bench_drmsd_kernel import (
    card_label, device_records)
from protein_transformer_tpu_torch.tools.bench_geometry import sync_sites
from protein_transformer_tpu_torch.training import flops as F
from protein_transformer_tpu_torch.training.batch_probe import (
    probe_trainer_batch_size)
from protein_transformer_tpu_torch.training.trainer import Trainer

LADDER = {
    1: dict(model="enc-only", d_model=64, d_ff=256, n_heads=2, n_layers=2,
            loss="mse", b=8, l=64, backbone_loss=False),
    2: dict(model="conv-enc|21,11,3|1,1,1", d_model=256, d_ff=1024,
            n_heads=8, n_layers=4, loss="mse", b=8, l=256,
            backbone_loss=False),
    3: dict(model="enc-only", d_model=256, d_ff=1024, n_heads=8, n_layers=4,
            loss="drmsd", b=8, l=256, backbone_loss=False),
    4: dict(model="conv-enc|21,11,3|1,1,1", d_model=512, d_ff=2048,
            n_heads=8, n_layers=6, loss="combined", b=8, l=256,
            backbone_loss=False),
    5: dict(model="conv-enc|21,11,3|1,1,1", d_model=1024, d_ff=4096,
            n_heads=8, n_layers=6, loss="lndrmsd", b=4, l=500,
            backbone_loss=True),
}
WINDOW_REPEATS = 8
TRACED_STEPS = 3
KEEP_FRACTION = 0.8


def ladder_config(idx: int, b: int, out_dir: str, dtype: str = "float32",
                  dropout: float = 0.1, optimizer: str = "adam",
                  clip: float = 1.0, name: str | None = None,
                  length: int | None = None, **overrides) -> TrainConfig:
    """The TrainConfig of ladder entry ``idx`` at batch ``b``, as the JAX
    tool builds it: one length bucket, train only, Noam. ``length`` and
    ``overrides`` narrow it for the tests."""
    spec = LADDER[idx]
    length = length or spec["l"]
    fields = dict(
        model=spec["model"], d_model=spec["d_model"], d_ff=spec["d_ff"],
        n_heads=spec["n_heads"], n_layers=spec["n_layers"], loss=spec["loss"],
        backbone_loss=spec["backbone_loss"], optimizer=optimizer, clip=clip,
        lr_scheduling="noam", dropout=dropout, max_seq_len=length,
        bucket_sizes=(length,), batch_size=b, train_only=True,
        name=name or f"ladder{idx}", out_dir=out_dir, compute_dtype=dtype)
    return TrainConfig(**{**fields, **overrides})


def ladder_trainer(cfg: TrainConfig, device: torch.device) -> Trainer:
    """A Trainer of ``cfg`` on ``device`` with the JAX tool's synthetic
    data: min(B, 64) training proteins of length L-1 to L, built on the
    host as the JAX tool builds them (so that the set-up launches no
    kernel)."""
    length = cfg.max_seq_len
    data = make_dataset(n_train=min(cfg.batch_size, 64), n_eval=2,
                        min_len=length - 1, max_len=length, seed=0)
    return Trainer(cfg, device, data)


def ladder_batch(trainer: Trainer, b: int):
    """Rows ``np.resize(arange(n), b)`` of the training split, collated by
    hand to (b, L) and moved to the trainer's device once."""
    ds = trainer.dm.train
    batch = collate(ds, np.resize(np.arange(len(ds)), b),
                    trainer.cfg.bucket_sizes, trainer.dm.max_seq_len,
                    batch_multiple=trainer.dm.batch_multiple)
    want = (b, trainer.cfg.max_seq_len)
    if batch.seq.shape != want:
        raise ValueError(f"collated {batch.seq.shape}, expected {want}")
    return batch.to(trainer.device)


def synchronizer(device: torch.device):
    """A function that waits for the device's queued work (nothing to wait
    for on the CPU)."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def timed_window(run, n: int, sync, clock=time.perf_counter) -> float:
    """Seconds of ``run(n)`` and one ``sync()`` after it."""
    t0 = clock()
    run(n)
    sync()
    return clock() - t0


def paired_samples(window, k: int, repeats: int) -> list[float]:
    """Seconds per step from ``repeats`` pairs of windows: (window(2k) -
    window(k)) / k each, which cancels what every window pays once."""
    samples = []
    for _ in range(repeats):
        t1, t2 = window(k), window(2 * k)
        samples.append((t2 - t1) / k)
    return samples


def window_steps(steps: int) -> int:
    """k of the JAX tool: a tenth of ``steps``, at least 5."""
    return max(5, steps // 10)


class StepRunner:
    """``run(n)`` takes n training steps of ``trainer`` on one ``batch``,
    from ``state`` on, keeping the last state and metrics and counting the
    steps."""

    def __init__(self, trainer: Trainer, state, batch):
        self.trainer, self.state, self.batch = trainer, state, batch
        self.metrics = None
        self.steps_run = 0

    def __call__(self, n: int = 1) -> None:
        for _ in range(n):
            self.state, self.metrics = self.trainer.train_step(self.state,
                                                               self.batch)
            self.steps_run += 1


def timed_steps(run: StepRunner, steps: int, sync) -> dict:
    """The paired-window timing of a train step: two warm-up steps, each
    ending in a ``sync()``, then WINDOW_REPEATS pairs of a k-step and a
    2k-step window (k = ``window_steps(steps)``). Returns the seconds per
    step of each pair ("samples"), each window's seconds in order
    ("windows") and the first warm-up step's loss ("first_loss")."""
    run(1)
    sync()
    first_loss = float(run.metrics[0])  # METRIC_KEYS[0] == "loss"
    run(1)
    sync()
    windows = []

    def window(n):
        windows.append(timed_window(run, n, sync))
        return windows[-1]

    samples = paired_samples(window, window_steps(steps), WINDOW_REPEATS)
    return {"samples": samples, "windows": windows, "first_loss": first_loss}


def probe_batch(idx: int, dtype: str, multiple: int, device: str = "cuda",
                run=subprocess.run) -> tuple[int, int]:
    """(the frontier MAXB that a ``--probe-only`` subprocess prints, the
    batch to bench at): 0.8 MAXB stepped down until the collate lattice
    keeps it (``bucket_batch_size(b, multiple) == b``), so that no row is
    padding. A subprocess that fails or prints no MAXB raises with the end
    of its stderr, and so does a frontier below the lattice's first
    point."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    proc = run([sys.executable, "-m",
                "protein_transformer_tpu_torch.tools.bench_ladder",
                "--configs", str(idx), "--dtype", dtype, "--probe-only",
                "--device", device],
               capture_output=True, text=True, env=env)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("MAXB=")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"the probe subprocess failed (exit "
                           f"{proc.returncode}): {proc.stderr[-2000:]}")
    maxb = int(lines[-1].split("=", 1)[1])
    b = max(1, int(KEEP_FRACTION * maxb))
    while b > 0 and bucket_batch_size(b, multiple) != b:
        b -= 1
    if b == 0:
        raise RuntimeError(f"no batch of the collate lattice (multiples of "
                           f"{multiple}) is at most 0.8 x MAXB={maxb}")
    return maxb, b


def device_profile(step, steps: int = TRACED_STEPS) -> dict:
    """Device operations and device ms per step() from a ``torch.profiler``
    trace of ``steps`` calls (retaken when it comes back without device
    records), and the stream synchronisations of one more call."""
    records = device_records(step, steps)
    return {"device_ops": sum(e.count for e in records) / steps,
            "device_ms": sum(e.self_device_time_total
                             for e in records) / 1e3 / steps,
            "syncs_per_step": len(sync_sites(step))}


def bench_config(idx: int, steps: int, dtype: str = "float32",
                 b_override: int | None = None,
                 probe_max_batch: bool = False, dropout: float = 0.1,
                 optimizer: str = "adam", clip: float = 1.0,
                 device: torch.device | None = None) -> dict:
    """One ladder entry's line: the JAX tool's keys, the card, and the
    device figures of a step (None on the CPU)."""
    device = torch.device(device) if device is not None else cuda_device()
    spec = LADDER[idx]
    b, length = b_override or spec["b"], spec["l"]
    out = {"config": idx, "loss": spec["loss"]}
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = ladder_config(idx, b, out_dir, dtype, dropout, optimizer, clip)
        trainer = ladder_trainer(cfg, device)
        if probe_max_batch:
            # The framework's own operating point: 0.8x the memory frontier
            # (the reference's -adbs), probed in a SUBPROCESS. After an
            # out-of-memory error the caching allocator holds a fragmented
            # pool and cuBLAS may have lost its workspace, so the process
            # that measures must never have run out of memory itself.
            out["maxb"], b = probe_batch(idx, dtype,
                                         trainer.dm.batch_multiple,
                                         device.type)
            cfg.batch_size = b
            del trainer
            trainer = ladder_trainer(cfg, device)
        state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
        run = StepRunner(trainer, state, ladder_batch(trainer, b))
        samples = timed_steps(run, steps, synchronizer(device))["samples"]
        dt = float(np.median(samples))
        p95 = float(np.percentile(samples, 95))
        on_card = device.type == "cuda"
        measured = (device_profile(run) if on_card else
                    dict.fromkeys(("device_ops", "device_ms",
                                   "syncs_per_step")))
        loss_value = float(run.metrics[0])
    out.update({
        "b": b, "l": length, "dtype": dtype, "dropout": dropout,
        "optimizer": optimizer, "clip": clip,
        "step_ms": round(dt * 1e3, 2), "step_ms_p95": round(p95 * 1e3, 2),
        "res_per_sec": round(b * length / dt, 1),
        "tflops_per_step": round(F.train_step_flops(cfg, b, length) / 1e12,
                                 4),
        "mfu": (round(F.mfu(cfg, b, length, dt,
                            device_name=torch.cuda.get_device_name(device)),
                      4) if on_card else None),
        "loss_value": loss_value,
        "card": card_label() if on_card else None, "tf32": False,
        **measured,
        # not clipped at 0: a device time above the step's wall time
        # (profiler overhead, a miscounted trace) shows as a negative share
        "idle_share": (1.0 - measured["device_ms"] / (dt * 1e3)
                       if on_card else None),
        "steps_run": run.steps_run})
    return out


def probe_only(idx: int, dtype: str, device: torch.device) -> int:
    """Probe the config's memory frontier and print ``MAXB=<raw max>``.
    Runs as a subprocess of ``--max-batch``, so that the process that
    measures never runs out of memory itself."""
    spec = LADDER[idx]
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = ladder_config(idx, spec["b"], out_dir, dtype,
                            name=f"ladder{idx}probe")
        trainer = ladder_trainer(cfg, device)
        raw = probe_trainer_batch_size(trainer, length=spec["l"],
                                       start=max(spec["b"], 1),
                                       keep_fraction=1.0)
    print(f"MAXB={raw}", flush=True)
    return raw


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", type=int, nargs="*", default=[1, 3, 4, 5],
                    choices=sorted(LADDER))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--batch", type=int, default=None,
                    help="override the config's batch size")
    ap.add_argument("--max-batch", action="store_true",
                    help="probe the memory frontier (-adbs) and bench at "
                         "0.8x")
    ap.add_argument("--probe-only", action="store_true",
                    help="internal: print MAXB=<raw frontier> and exit")
    ap.add_argument("--dropout", type=float, default=0.1,
                    help="ablation override (step-time decomposition)")
    ap.add_argument("--optimizer", default="adam",
                    choices=["adam", "sgd"], help="ablation override")
    ap.add_argument("--clip", type=float, default=1.0,
                    help="ablation override; 0 disables global-norm clip")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the steps on the CPU (tests only)")
    args = ap.parse_args(argv)
    device = (cuda_device() if args.device == "cuda"
              else torch.device("cpu"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.probe_only:
        for idx in args.configs:
            probe_only(idx, args.dtype, device)
        return []
    lines = []
    for idx in args.configs:
        lines.append(bench_config(idx, args.steps, args.dtype,
                                  b_override=args.batch,
                                  probe_max_batch=args.max_batch,
                                  dropout=args.dropout,
                                  optimizer=args.optimizer, clip=args.clip,
                                  device=device))
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
