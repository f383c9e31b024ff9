"""Structure logging's cost on the train loop, on one GPU.

The flagship conv-enc training (``conv-enc|21,11,3|1,1,1``, d_model 512,
d_ff 2048, 8 heads, 6 layers, the combined loss, dropout 0.1, Adam with
Noam; the sampler's batches of 15 proteins of length 255-256 in 16 rows;
the device store), run by ``Trainer.train_epoch`` from random seeded
weights in two arms, epochs interleaved (off, on, on, off, ...):

* on: structure logging at the config's default cadences,
  ``--log_structure_step`` 10 (one training structure every 10 steps) and
  ``--log_val_struct_step`` 50 (one structure of each of the seven
  validation splits every 50 steps);
* off: both cadences 0.

For each arm: ms a train step (host clock around an epoch that ends in
``torch.cuda.synchronize()`` and, in the on arm, the logger's ``close()``,
which waits for its last files; median over the arm's epochs), the loop
profile's host ms a step by span (``PTT_LOOP_PROFILE=1``), the stream
synchronisations of its epochs on the train loop (the logger's worker
copies the structures to the host, and waits for the device there, by
design: those are counted apart), and the device operations and device ms
a step from a ``torch.profiler`` trace of the device activity of one more
epoch.

Times the port whose ``protein_transformer_tpu_torch`` this imports. Run as
a script with another checkout's root first on ``PYTHONPATH`` it times that
checkout's logger and loop instead (a checkout whose port has
``tracing.py``), so that two versions are compared in
one run on one card (in turns: parent, change, change, parent):

    python -m protein_transformer_tpu_torch.tools.bench_logging
    PYTHONPATH=<other checkout> python <this file>

Prints one line per arm with the card's name and power limit, then the
results as one JSON object. ``run``'s sizes are keyword arguments for the
tests, which run the loop narrow on the CPU (no device figure there); the
command line runs the flagship on the card alone.

``--writer`` times the logger's worker alone instead, on the host: ms of
``StructureLogger._write`` (the PDB file, two ``.glb`` files and the
Kabsch fit of one structure, the true structure's files already written)
at L = 256 and 500, median of 10 calls, and its five costliest sites under
cProfile.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import tempfile
import time

import torch

from protein_transformer_tpu_torch import tracing
from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.tools.bench_drmsd_kernel import (
    card_label, on_device)
from protein_transformer_tpu_torch.tools.bench_geometry import sync_sites
from protein_transformer_tpu_torch.training.trainer import (
    LoopProfiler, Trainer)

MODEL = "conv-enc|21,11,3|1,1,1"
DEFAULTS = TrainConfig()
CADENCES = {"off": (0, 0),
            "on": (DEFAULTS.log_structure_step, DEFAULTS.log_val_struct_step)}
ORDER = ("off", "on", "on", "off")


def trainer(arm: str, device: torch.device, data, out_dir: str,
            d_model: int, layers: int, length: int, repeat: int) -> Trainer:
    every, val_every = CADENCES[arm]
    cfg = TrainConfig(
        model=MODEL, d_model=d_model, d_ff=4 * d_model,
        n_heads=8 if d_model >= 256 else 2, n_layers=layers,
        loss="combined", dropout=0.1, optimizer="adam",
        lr_scheduling="noam", batch_size=8, bucket_sizes=(length,),
        max_seq_len=length, repeat_train=repeat,
        log_structure_step=every, log_val_struct_step=val_every,
        save_pngs=False, cluster=True, out_dir=out_dir, name=arm)
    return Trainer(cfg, device, data)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def epoch(tr: Trainer, state):
    """One train epoch and the logger's close(): (state, seconds, steps,
    the loop profile's ms a step by phase: each span's own host ms, as
    ``LoopProfiler`` reports them)."""
    os.environ[tracing.SWITCH] = "1"
    try:
        synchronize(tr.device)
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            new = tr.train_epoch(state)
        synchronize(tr.device)
        tr.structure_logger.close()
        seconds = time.perf_counter() - t0
    finally:
        del os.environ[tracing.SWITCH]
    prof = LoopProfiler.of(tracing.last_session())
    phases = {k: 1e3 * v / max(prof.steps, 1) for k, v in prof.t.items()}
    return new, seconds, new.step - state.step, phases


def device_activity(fn) -> tuple:
    """(device operations, device ms) of one fn() call, from a trace of the
    device activity alone (an epoch is ~10^5 operations: a trace of the
    host side too takes minutes to read); (None, None) for a trace without
    device records."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = on_device(prof)
    if not rows:
        return None, None
    return (sum(e.count for e in rows),
            sum(e.self_device_time_total for e in rows) / 1e3)


def costliest_sites(fn, calls: int = 1, top: int = 5) -> list:
    """The ``top`` Python sites of ``calls`` fn() calls by their own time
    under cProfile: (file:line(function), own ms a call, calls a call)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    ranked = sorted(pstats.Stats(prof).stats.items(),
                    key=lambda kv: -kv[1][2])[:top]
    return [(f"{os.path.basename(f)}:{line}({name})", 1e3 * tt / calls,
             nc / calls) for (f, line, name), (_, nc, tt, _, _) in ranked]


def run(device: torch.device, d_model: int = 512, layers: int = 6,
        length: int = 256, repeat: int = 50) -> dict:
    """The two arms' figures, {"off": {...}, "on": {...}, "card": ...};
    prints a line for each."""
    on_card = device.type == "cuda"
    card = card_label() if on_card else "cpu"
    data = make_dataset(n_train=16, n_eval=2, min_len=length - 1,
                        max_len=length, seed=2, device=device)
    results = {"card": card}
    with tempfile.TemporaryDirectory() as out_dir:
        trainers = {arm: trainer(arm, device, data, out_dir, d_model,
                                 layers, length, repeat)
                    for arm in CADENCES}
        states = {arm: tr.init_state(torch.Generator().manual_seed(0))
                  for arm, tr in trainers.items()}
        # each arm's epochs: (ms a step, loop profile phases, steps)
        box = {arm: [] for arm in CADENCES}

        def one_epoch(arm):
            states[arm], seconds, steps, phases = epoch(trainers[arm],
                                                        states[arm])
            box[arm].append((1e3 * seconds / steps, phases, steps))

        for arm in CADENCES:  # warm-up
            one_epoch(arm)
            box[arm].clear()
        syncs = {arm: [] for arm in CADENCES}
        for arm in ORDER:
            if on_card:
                syncs[arm] += sync_sites(lambda: one_epoch(arm))
            else:
                one_epoch(arm)
        for arm, tr in trainers.items():
            times = [ms for ms, _, _ in box[arm]]
            loop = [x for x in syncs[arm] if "structure_logging" not in x]
            out = {"ms": statistics.median(times), "ms_each": times,
                   "phases_ms": {k: statistics.median(p.get(k, 0.0)
                                                      for _, p, _ in box[arm])
                                 for k in box[arm][0][1]},
                   "loop_syncs": loop,
                   "worker_syncs": len(syncs[arm]) - len(loop),
                   "device_ops": None, "device_ms": None}
            if on_card:
                ops, dev_ms = device_activity(lambda: one_epoch(arm))
                if ops is not None:
                    steps = box[arm][-1][2]
                    out["device_ops"] = ops / steps
                    out["device_ms"] = dev_ms / steps
            out["files"] = sum(len(files) for _, _, files in os.walk(
                os.path.join(tr.out_dir, "structures")))
            results[arm] = out
            ph = ", ".join(f"{k} {v:.2f}" for k, v in
                           out["phases_ms"].items())
            dev = ("device figures not measured" if out["device_ops"] is None
                   else f"{out['device_ops']:.1f} device operations and "
                   f"{out['device_ms']:.3f} device ms a step")
            if on_card:
                dev += (f"; {len(loop)} stream synchronisations on the "
                        f"train loop ({', '.join(sorted(set(loop))) or '-'}),"
                        f" {out['worker_syncs']} in the worker")
            print(f"[bench_logging] structure logging {arm} (cadences "
                  f"{CADENCES[arm]}): {out['ms']:.2f} ms a train step "
                  f"(epochs: " + ", ".join(f"{t:.2f}" for t in times)
                  + f"); {dev}; loop profile ms a step: {ph}; "
                  f"{out['files']} files ({card})")
    return results


def writer_profile(lengths=(256, 500), calls: int = 10) -> dict:
    """{L: (median ms of one ``_write``, its costliest sites)} of random
    structures with 20% of the true atoms missing."""
    import numpy as np

    from protein_transformer_tpu_torch.training.structure_logging import (
        StructureLogger)
    rng = np.random.default_rng(0)
    out = {}
    for length in lengths:
        seq = rng.integers(0, 20, length)
        pred = rng.normal(0, 10, (length, 14, 3)).astype(np.float32)
        true = rng.normal(0, 10, (length, 14, 3)).astype(np.float32)
        mask = rng.random((length, 14)) > 0.2
        step = iter(range(1, 2 * calls + 1))
        with tempfile.TemporaryDirectory() as out_dir:
            logger = StructureLogger(out_dir)
            logger._write(0, "train", seq, pred, true, mask)

            def write():
                logger._write(next(step), "train", seq, pred, true, mask)

            times = []
            for _ in range(calls):
                t0 = time.perf_counter()
                write()
                times.append(1e3 * (time.perf_counter() - t0))
            sites = costliest_sites(write, calls)
        out[length] = (statistics.median(times), sites)
        print(f"[bench_logging] StructureLogger._write at L = {length}: "
              f"{out[length][0]:.2f} ms (median of {calls}); own ms a call: "
              + "; ".join(f"{site} {ms:.2f}" for site, ms, _ in sites)
              + " (host)")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--writer", action="store_true",
                   help="time the logger's worker alone, on the host")
    args = p.parse_args(argv)
    if args.writer:
        return writer_profile()
    if not torch.cuda.is_available():
        raise SystemExit("bench_logging times the card: no CUDA device")
    results = run(torch.device("cuda"))
    print(json.dumps(results))
    return results

if __name__ == "__main__":
    main()
