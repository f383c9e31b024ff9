"""The port's bench: training and eval throughput of the flagship on one GPU.

The counterpart of the JAX package's root ``bench.py``, with its three
modes, configurations, environment variables and output:

* headline (default): the raw training step (``Trainer.train_step``) of
  conv-enc|21,11,3|1,1,1 at d_model 512, d_ff 2048, 8 heads, 6 layers,
  combined loss (NeRF, sidechains and dRMSD in the step), Adam + Noam,
  dropout 0.1, fp32, on B=8 x L=256: 8 synthetic proteins collated by hand
  and moved to the card once. That is ``tools/bench_ladder.py``'s config 4,
  built and timed by the ladder's own functions: two warm-up steps, then
  eight repeats of a k-step and a 2k-step window (k = max(5, BENCH_STEPS //
  10)), each ending in one synchronisation; (T2 - T1) / k cancels what
  every window pays once;
* ``BENCH_MODE=trainer``: two epochs of ``Trainer.train`` on 16 proteins
  with ``repeat_train`` = BENCH_STEPS (default 30), on the default data
  path; reports the mean of the last epoch's ``speed-history``, the
  reference's own statistic. Its sampler forms batches from a residue
  budget of ``batch_size`` x 500, so its steps run B ~ 16, not 8;
* ``BENCH_MODE=eval``: ``Trainer.eval_step`` (every dRMSD metric and the
  Kabsch RMSD) at d_model 1024, d_ff 4096, ln-dRMSD, B=4 x L=500 (the
  ladder's config 5 without its backbone loss, as the root bench has it),
  over BENCH_STEPS calls ending in one synchronisation.

    python -m protein_transformer_tpu_torch.bench
    BENCH_MODE=trainer|eval BENCH_STEPS=30 \\
        python -m protein_transformer_tpu_torch.bench

Stdout ends in one JSON line, {"metric", "value", "unit", "vs_baseline"};
``vs_baseline`` compares the headline with the reference's throughput in
``tools/reference_bench.json`` (torch on the CPU). Stderr names the card,
its power limit and the TF32 setting (off, for matrix products and cuDNN
alike; ``torch.backends.cudnn.benchmark`` stays at PyTorch's default,
False, which the trainer does not change), then the mode's times.
"Per chip" divides by the cards the step runs on: one, or the world size
under ``parallel/``. Without a GPU it raises; ``--device cpu`` runs on the
CPU for the tests, with no MFU. ``tools/bench_protocol.py`` runs it in
fresh processes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.dataset import bucket_batch_size
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.parallel import distributed
from protein_transformer_tpu_torch.tools.bench_drmsd_kernel import card_label
from protein_transformer_tpu_torch.tools.bench_ladder import (
    StepRunner, ladder_batch, ladder_config, ladder_trainer, synchronizer,
    timed_steps, window_steps)
from protein_transformer_tpu_torch.training import flops as F
from protein_transformer_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_BENCH = os.path.join(ROOT, "tools", "reference_bench.json")
UNIT = "residues/sec/chip"
# the ladder entries of the modes: the headline and the trainer loop are
# config 4 (the flagship), the eval mode is config 5's model and shape
HEADLINE, EVAL = 4, 5


def hand_batch(cfg: TrainConfig, device: torch.device):
    """(trainer, fresh state, batch on the device) of ``cfg`` with exactly
    ``cfg.batch_size`` proteins collated by hand: the sampler's residue
    budget would pick another batch size for this workload."""
    trainer = ladder_trainer(cfg, device)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    return trainer, state, ladder_batch(trainer, cfg.batch_size)


def vs_baseline(res_per_sec: float) -> float | None:
    """Throughput over the reference's (``tools/reference_bench.json``),
    None when the file is absent."""
    if not os.path.exists(REFERENCE_BENCH):
        return None
    with open(REFERENCE_BENCH) as f:
        return res_per_sec / json.load(f)["residues_per_sec"]


def step_time_line(p50: float, p95: float, n_windows: int, k: int,
                   sync_ms: float, n_chips: int, mfu_pct: float | None,
                   gflop: float) -> str:
    """The headline's stderr line, worded as the root bench's, so that
    the protocol's ``p50: ([\\d.]+) ms`` and ``MFU ([\\d.]+)%`` match it."""
    mfu = (f"MFU {mfu_pct:.1f}% ({gflop:.1f} GFLOP/step vs bf16 peak)"
           if mfu_pct is not None else
           f"MFU not measured on the CPU ({gflop:.1f} GFLOP/step)")
    return (f"# step time p50: {p50 * 1000:.2f} ms, p95: {p95 * 1000:.2f} ms"
            f" ({n_windows} paired windows of {k}/{2 * k} steps, window sync"
            f" overhead ~{sync_ms:.1f} ms); devices: {n_chips}; steps/sec: "
            f"{1 / p50:.2f}; {mfu}")


def run_headline(trainer: Trainer, state, batch, steps: int) -> dict:
    """Time the headline's train step on ``batch`` from ``state`` with the
    ladder's paired windows; prints the step-time line on stderr and
    returns the JSON line ("line"), the first warm-up step's loss, the p50
    and the steps run."""
    cfg, device = trainer.cfg, trainer.device
    b, l = batch.seq.shape
    run = StepRunner(trainer, state, batch)
    timed = timed_steps(run, steps, synchronizer(device))
    samples, windows = timed["samples"], timed["windows"]
    dt = float(np.median(samples))
    p95 = float(np.percentile(samples, 95))
    # what every window pays once: t1 - (t2 - t1)
    sync_ms = 1000 * float(np.median(
        [t1 - (t2 - t1) for t1, t2 in zip(windows[0::2], windows[1::2])]))
    res_per_sec = b * l / dt
    n_chips = trainer.process_count
    ratio = vs_baseline(res_per_sec)
    mfu_pct = (100 * F.mfu(cfg, b, l, dt, n_chips=n_chips,
                           device_name=torch.cuda.get_device_name(device))
               if device.type == "cuda" else None)
    print(step_time_line(dt, p95, len(samples), window_steps(steps),
                         sync_ms, n_chips, mfu_pct,
                         F.train_step_flops(cfg, b, l) / 1e9),
          file=sys.stderr)
    line = {
        "metric": (f"train residues/sec/chip, conv-enc dm={cfg.d_model} "
                   f"nl={cfg.n_layers} combined loss (on-device "
                   f"NeRF+dRMSD), B={b}xL={l}"),
        "value": round(res_per_sec / n_chips, 1),
        "unit": UNIT,
        "vs_baseline": round(ratio / n_chips, 2) if ratio else None,
    }
    return {"line": line, "first_loss": timed["first_loss"],
            "p50_ms": dt * 1e3, "steps_run": run.steps_run}


def main_headline(device: torch.device, out_dir: str, steps: int, *, b=8,
                  l=256, **sizes) -> dict:
    """The headline mode: ladder config 4 at B x L; ``sizes`` (d_model,
    d_ff, n_heads, n_layers) narrow it for the tests."""
    cfg = ladder_config(HEADLINE, b, out_dir, name="bench", length=l,
                        **sizes)
    return run_headline(*hand_batch(cfg, device), steps)


def bench_trainer_loop(device: torch.device, out_dir: str, steps: int, *,
                       b=8, l=256, **sizes) -> dict:
    """The real loop: two epochs of ``Trainer.train`` of ladder config 4
    on 16 proteins with ``repeat_train`` = ``steps``, structure logging at
    the config's cadence (wandb off). Epoch one is the warm-up; the last
    epoch is the measurement."""
    cfg = ladder_config(HEADLINE, b, out_dir, name="bench_loop", length=l,
                        epochs=2, repeat_train=steps, **sizes)
    data = make_dataset(n_train=16, n_eval=2, min_len=l - 1, max_len=l,
                        seed=0)
    trainer = Trainer(cfg, device, data)
    print(f"# structure logging every {cfg.log_structure_step} train steps"
          f" (log_structure_step), validation structures every "
          f"{cfg.log_val_struct_step} (log_val_struct_step); wandb off",
          file=sys.stderr)
    # the first epoch's batches, drawn with the trainer's own seed before
    # the run; later epochs draw the same number of batches
    plan = [len(idx) for idx in trainer.dm.train_index_batches(
        np.random.default_rng(cfg.seed))]
    padded = sorted({bucket_batch_size(n, trainer.dm.batch_multiple)
                     for n in plan})
    epoch_seconds = []
    orig_epoch = trainer.train_epoch

    def timed_epoch(state, logger=None):
        t0 = time.perf_counter()
        out = orig_epoch(state, logger)
        epoch_seconds.append(time.perf_counter() - t0)
        return out

    trainer.train_epoch = timed_epoch
    state = trainer.train()
    hist = trainer.metrics["train"]["speed-history"]
    speed = float(np.mean(hist)) if hist else 0.0
    print(f"# last epoch: {len(hist)} steps in {epoch_seconds[-1]:.2f}s; "
          f"sampler batches of {min(plan)}-{max(plan)} proteins in "
          f"B={'/'.join(map(str, padded))} rows x L={l} (a residue budget "
          f"of {cfg.batch_size} x 500), {len(plan)} steps an epoch",
          file=sys.stderr)
    line = {"metric": "trainer-loop residues/sec/chip (real Trainer.train "
                      "epoch)",
            "value": round(speed / trainer.process_count, 1),
            "unit": UNIT, "vs_baseline": None}
    return {"line": line, "steps_run": state.step,
            "steps_per_epoch": len(plan), "epochs": len(epoch_seconds)}


def bench_eval(device: torch.device, out_dir: str, steps: int, *, b=4,
               l=500, **sizes) -> dict:
    """Eval-step throughput at ladder config 5's model and shape, with the
    root bench's full-atom ln-dRMSD (no backbone loss): one warm call, then
    ``steps`` calls ending in one synchronisation."""
    cfg = ladder_config(EVAL, b, out_dir, name="bench_eval", length=l,
                        backbone_loss=False, **sizes)
    trainer, state, batch = hand_batch(cfg, device)
    sync = synchronizer(device)
    out = trainer.eval_step(state.params, batch)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = trainer.eval_step(state.params, batch)
    sync()
    dt = (time.perf_counter() - t0) / steps
    print(f"# eval step time: {dt * 1000:.1f} ms", file=sys.stderr)
    line = {"metric": (f"eval residues/sec/chip, conv-enc dm={cfg.d_model} "
                       f"all-dRMSD + Kabsch RMSD, B={b}xL={l}"),
            "value": round(b * l / dt / trainer.process_count, 1),
            "unit": UNIT, "vs_baseline": None}
    return {"line": line, "metrics": out.cpu(), "steps_run": steps + 1}


# BENCH_MODE -> the mode; any other value runs the headline, as in the root
# bench
MODES = {"raw": main_headline, "trainer": bench_trainer_loop,
         "eval": bench_eval}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the bench on the CPU (tests only)")
    args = ap.parse_args(argv)
    device = (cuda_device(distributed.local_device_index())
              if args.device == "cuda" else torch.device("cpu"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"# card: {card_label()}" if device.type == "cuda"
          else "# device: cpu (no card)", file=sys.stderr)
    print(f"# TF32 off (matmul and cuDNN); cudnn.benchmark "
          f"{torch.backends.cudnn.benchmark}", file=sys.stderr)
    steps = int(os.environ.get("BENCH_STEPS", "30"))
    mode = MODES.get(os.environ.get("BENCH_MODE", "raw"), MODES["raw"])
    with tempfile.TemporaryDirectory() as out_dir:
        result = mode(device, out_dir, steps)
    print(json.dumps(result["line"]), flush=True)
    return result


if __name__ == "__main__":
    main()
