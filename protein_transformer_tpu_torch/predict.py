"""Prediction tooling: checkpoint -> angle predictions -> PDB structures.

Port of protein_transformer_tpu/predict.py: load a run written by the
port's training CLI (or imported from a JAX run, see
``training/checkpoint.py``), predict angles for dataset items in eval mode,
rebuild all-atom coordinates on the device, and write pred/true PDB pairs.
``--reconstruct`` rebuilds the TRUE structures from the TRUE angles, a
geometry check. With ``attention_impl: "flash"`` in the run's
``config.json`` every encoder layer's attention goes through
``ops/attention.py`` (the flash kernels on a CUDA device). An
encoder-decoder run is predicted as the JAX package predicts it: one
teacher-forced pass on the split's true angles.

The run goes to the GPU unless ``--device cpu`` asks for the CPU; without a
GPU ``--device cuda`` raises.

Run: python -m protein_transformer_tpu_torch.predict <run_dir> --data <path>
         [--split test] [--n 5] [--reconstruct] [--out preds/]
         [--checkpoint best] [--batch 8] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.dataset import (
    DataModule, collate, load_dataset)
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.models.factory import (
    make_model, model_args)
from protein_transformer_tpu_torch.ops import sidechain
from protein_transformer_tpu_torch.protein.geometry import (
    build_coords_batch, inverse_trig_transform)
from protein_transformer_tpu_torch.protein.pdb import PdbWriter
from protein_transformer_tpu_torch.training.checkpoint import (
    CheckpointManager)


def _device(device: torch.device | str | None) -> torch.device:
    """``device``, or the GPU when none is given; never the CPU unasked."""
    return cuda_device() if device is None else torch.device(device)


def load_run(run_dir: str, modifier: str = "best",
             device: torch.device | str | None = None):
    """(cfg, model) of a training run directory: the model of its
    ``config.json`` on ``device``, in eval mode, with the parameters of the
    checkpoint ``modifier``. Without a ``device`` the model goes to the GPU,
    and the call raises where there is none; pass "cpu" to ask for the CPU."""
    device = _device(device)
    with open(os.path.join(run_dir, "config.json")) as f:
        saved = json.load(f)
    cfg = TrainConfig.from_dict(saved["config"]).finalize()
    angle_means = np.asarray(saved["angle_means"], np.float32)
    model = make_model(cfg, angle_means)

    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    result = ckpt.restore_raw(modifier)
    if result is None:
        raise FileNotFoundError(
            f"no '{modifier}' checkpoint in {run_dir}/checkpoints")
    arrays, _meta = result
    # a state with buffers (a sparse-expert model's correction biases)
    # saved them beside the parameters
    model.load_state_dict({**arrays["params"], **arrays.get("buffers", {})})
    return cfg, model.to(device).eval()


def predict_structures(run_dir: str, data_path: str, split: str = "test",
                       n: int = 5, out_dir: str = "predictions",
                       reconstruct: bool = False, modifier: str = "best",
                       batch_size: int = 8,
                       device: torch.device | str | None = None) -> list[str]:
    """Predict n structures from a split; returns the written PDB paths.
    ``device`` as for ``load_run``: the GPU unless the caller names one.

    Inference is batched on the bucket lattice: length-sorted groups of up
    to batch_size proteins, padded by ``collate`` to a bucketed (B, L)
    shape. Rows beyond the group are padding only (no valid key); every
    protein's output is what the unbatched path gives."""
    device = _device(device)
    os.makedirs(out_dir, exist_ok=True)
    data = load_dataset(data_path)
    cfg, model = load_run(run_dir, modifier, device)
    sidechain_impl = sidechain.resolve_impl(cfg.sidechain_impl, device)
    dm = DataModule(data, cfg)
    ds = dm.eval_splits[split] if split != "train" else dm.train

    @torch.inference_mode()
    def infer(seq, ang):
        sincos = ang if reconstruct else model(*model_args(model, seq, ang))
        return build_coords_batch(inverse_trig_transform(sincos), seq,
                                  sidechain_impl)

    # length-descending order packs same-bucket proteins together
    sel = np.arange(min(n, len(ds)))
    order = sel[np.argsort(-ds.lens[sel], kind="stable")]
    tag = "recon" if reconstruct else "pred"
    paths = []
    for start in range(0, len(order), batch_size):
        idx = order[start:start + batch_size]
        batch = collate(ds, idx, cfg.bucket_sizes, dm.max_seq_len)
        on_device = batch.to(device)
        crd_all = infer(on_device.seq, on_device.ang).cpu().numpy()
        for row, i in enumerate(idx):
            li = int(ds.lens[i])
            seq_str = ds.seqs[i][:li]
            pdb_path = os.path.join(out_dir, f"{ds.ids[i]}_{tag}.pdb")
            PdbWriter(crd_all[row, :li], seq_str).save_pdb(
                pdb_path, title=f"{tag} {ds.ids[i]}")
            paths.append(pdb_path)

            true_crd = np.where(batch.crd_mask[row, :li, :, None],
                                batch.crd[row, :li], np.nan)
            true_path = os.path.join(out_dir, f"{ds.ids[i]}_true.pdb")
            PdbWriter(true_crd, seq_str).save_pdb(true_path,
                                                  title=f"true {ds.ids[i]}")
            paths.append(true_path)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_dir")
    p.add_argument("--data", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--n", type=int, default=5)
    p.add_argument("--out", default="predictions")
    p.add_argument("--reconstruct", action="store_true")
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--batch", type=int, default=8,
                   help="inference batch size (bucket-padded)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda needs a GPU and raises without one; the CPU "
                        "is used only when asked for")
    args = p.parse_args(argv)
    paths = predict_structures(args.run_dir, args.data, args.split, args.n,
                               args.out, args.reconstruct, args.checkpoint,
                               batch_size=args.batch,
                               device=None if args.device == "cuda" else "cpu")
    for path in paths:
        print(path)
    return paths


if __name__ == "__main__":
    main()
