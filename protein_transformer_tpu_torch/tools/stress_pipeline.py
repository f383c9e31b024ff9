"""Input-pipeline stress test at production (CASP12) dataset scale.

The port's counterpart of the JAX package's ``tools/stress_pipeline.py``.
Measures, on a dataset of --n_train chains (default 24k, ~CASP12's
training-set order of magnitude), each stage a training run pays once or
per epoch:

  gen        one-time dataset generation (``tools/gen_scale_data.py``, run
             as a subprocess with ``--device`` passed through)
  load       cold shard read -> raw dict (``data/dataset.py::load_dataset``)
  split      ProteinSplit/BinnedDataset build (``DataModule``)
  store      DeviceStore flat-array build + device upload, synchronised
  plan       one full epoch of sampler batch planning (no compute)
  collate    one full epoch of host collate (the non-device-data path)

Prints one JSON line per stage. Anything superlinear between --n_train
values is a pipeline bug.

    python -m protein_transformer_tpu_torch.tools.stress_pipeline \\
        [--n_train 24000] [--out /tmp/stress_data] [--device cpu]

``--device cuda`` (the default) needs a GPU and raises without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data import device_store as DS
from protein_transformer_tpu_torch.data.dataset import (
    DataModule, load_dataset)
from protein_transformer_tpu_torch.device import cuda_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def stage(name, t0, **extra):
    row = {"stage": name, "seconds": round(time.time() - t0, 3), **extra}
    print(json.dumps(row), flush=True)
    return time.time()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_train", type=int, default=24000)
    ap.add_argument("--n_eval", type=int, default=1000)
    ap.add_argument("--out", default="/tmp/stress_data")
    ap.add_argument("--skip_gen", action="store_true",
                    help="reuse an existing --out dataset")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the generator builds and the store lives; "
                         "cuda needs a GPU and raises without one")
    args = ap.parse_args(argv)
    device = cuda_device() if args.device == "cuda" else torch.device("cpu")

    t0 = time.time()
    if not args.skip_gen:
        # the generator runs from this checkout whatever the working
        # directory
        path = [ROOT, *filter(None, [os.environ.get("PYTHONPATH")])]
        subprocess.run(
            [sys.executable, "-m",
             "protein_transformer_tpu_torch.tools.gen_scale_data",
             "--out", args.out, "--n_train", str(args.n_train),
             "--n_eval", str(args.n_eval), "--device", args.device],
            check=True, env=dict(os.environ, PYTHONPATH=os.pathsep.join(path)))
        t0 = stage("gen", t0, n_train=args.n_train)

    raw = load_dataset(args.out)
    n_res = sum(len(s) for s in raw["train"]["seq"])
    t0 = stage("load", t0, n_res=n_res,
               mb=round(sum(os.path.getsize(os.path.join(args.out, f))
                            for f in os.listdir(args.out)) / 1e6, 1))

    cfg = TrainConfig(name="stress", batch_size=8,
                      train_only=False).finalize()
    dm = DataModule(raw, cfg)
    t0 = stage("split", t0, n_train=len(dm.train),
               n_splits=1 + len(dm.eval_splits))

    store = DS.DeviceStore(dm.train, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    nbytes = DS.store_nbytes(dm.train)
    t0 = stage("store", t0, gb=round(nbytes / 1e9, 3), store_nbytes=nbytes,
               device_nbytes=store.device_nbytes())

    rng = np.random.default_rng(0)
    plans = 0
    n_planned = 0
    for idx in dm.train_index_batches(rng):
        plan = DS.plan_batch(dm.train, idx, cfg.bucket_sizes,
                             dm.max_seq_len, dm.batch_multiple)
        plans += 1
        n_planned += plan.n_real
    t0 = stage("plan", t0, batches=plans, proteins=n_planned)

    rng = np.random.default_rng(0)
    n_collated = 0
    for batch in dm.train_batches(rng):
        n_collated += int(batch.protein_mask.sum())
    t0 = stage("collate", t0, batches=plans, proteins=n_collated,
               res_per_sec=round(n_res / max(time.time() - t0, 1e-9)))


if __name__ == "__main__":
    main()
