"""Device time of the optimizer's update: the kernel (K6) beside the foreach
chain, on one GPU.

At the benchmark's two largest parameter sets, ``conv_enc_1024`` (87.1 M
fp32 parameters in its model's tensors) and one pipeline stage of
Moonlight-16B-A3B (2.42 B, ``benchmark/configs/moonlight16b_stage1.json``),
seeded weights and gradients and zero moments; Adam with the clip engaged,
weight decay and the Noam step, as the cells train:

* ms per update by CUDA events (median of 25, the host's work included),
  device ms from a ``torch.profiler`` trace of five updates, device
  operations and the kernel's launches per update, for both paths;
* achieved bytes/s over the 32 bytes a parameter the update needs at least
  (the clip's read of g, then p, g, mu, nu read and p, mu, nu written), and
  its share of 3.35 TB/s;
* the kernels' registers and spills, as ``ptxas -v`` gave them.

    python -m protein_transformer_tpu_torch.tools.bench_adam [--sets NAME ...]

Prints one line per set and path with the card's name and power limit,
then the results as one JSON line. Needs a CUDA device and raises without
one.
"""
from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np
import torch

from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.models.factory import make_model
from protein_transformer_tpu_torch.ops import _build
from protein_transformer_tpu_torch.ops import adam as A
from protein_transformer_tpu_torch.tools.bench_drmsd_kernel import (
    card_label, device_ms, device_records, event_ms)
from protein_transformer_tpu_torch.training import optim as O

CALLS = 5
PEAK_BYTES_PER_S = 3.35e12
BYTES_PER_PARAM = 32
MOONLIGHT = (Path(__file__).resolve().parents[2] / "benchmark" / "configs"
             / "moonlight16b_stage1.json")


def configs() -> dict:
    """The parameter sets by name: the TrainConfig of each."""
    return {
        "conv_enc_1024": TrainConfig(
            model="conv-enc|21,11,3|1,1,1", d_model=1024, d_ff=2048,
            n_heads=8, n_layers=6).finalize(),
        "moonlight16b_stage1": TrainConfig(
            **json.loads(MOONLIGHT.read_text())["program"]).finalize(),
    }


def shapes(cfg: TrainConfig) -> list:
    """The shapes of the model's parameter tensors, built on ``meta``."""
    with torch.device("meta"):
        model = make_model(cfg, np.zeros(24, np.float32))
    return [tuple(p.shape) for p in model.parameters()]


def ptxas_summary() -> list:
    """Each K6 kernel's registers and spill bytes from the build's log."""
    out, name = [], None
    for line in _build.ptxas_log("adam").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.append({"kernel": name, "spill_stores": int(m.group(1)),
                        "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers", line)
        if m and out and name:
            out[-1]["registers"] = int(m.group(1))
    return out


def bench_set(name: str, cfg: TrainConfig, device) -> dict:
    shp = shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = {f"p{i}": torch.randn(s, device=device, generator=gen) * 0.02
              for i, s in enumerate(shp)}
    grads = [torch.randn(s, device=device, generator=gen) * 1e-3
             for s in shp]
    n = sum(p.numel() for p in params.values())
    bound_ms = n * BYTES_PER_PARAM / PEAK_BYTES_PER_S * 1e3
    row = {"params": n, "tensors": len(shp), "bound_ms": bound_ms,
           "bound_by": "bytes"}
    for impl in ("cuda", "torch"):
        tx = O.Optimizer("adam", O.noam_schedule(cfg.d_model, 4000), True,
                         1.0, impl=impl)
        box = [tx.init(params)]

        def update(tx=tx, box=box):
            box[0] = tx.update(params, grads, box[0])

        launches = A.adam_update_cuda.launches
        update()
        launches = A.adam_update_cuda.launches - launches
        records = device_records(update, CALLS)
        dev = device_ms(update, CALLS)
        row[impl] = {
            "launches": launches,
            "device_ops": sum(e.count for e in records) / CALLS,
            "ms": event_ms(update), "device_ms": dev,
            "bytes_per_s": n * BYTES_PER_PARAM / (dev / 1e3),
            "share_of_peak": n * BYTES_PER_PARAM / (dev / 1e3)
            / PEAK_BYTES_PER_S}
        print(f"{name} ({n} params, {len(shp)} tensors) {impl}: "
              + json.dumps(row[impl]) + f" bound {bound_ms:.3f} ms "
              f"({card_label()})", flush=True)
        del tx, box
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sets", nargs="*", default=list(configs()),
                        choices=list(configs()))
    args = parser.parse_args(argv)
    device = cuda_device()
    results = {"card": card_label()}
    for name in args.sets:
        results[name] = bench_set(name, configs()[name], device)
    results["ptxas"] = ptxas_summary()
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
