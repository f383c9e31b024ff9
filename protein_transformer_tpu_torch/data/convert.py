"""Dataset conversion: reference torch .pt dict -> native .npz shard layout.

The port's own copy of protein_transformer_tpu/data/convert.py, loading
through the port's ``data/dataset.py::load_dataset``.

The reference stores everything in one ~3 GB torch pickle
(README.md:241-254; produced by scripts/proteinnet2pytorch.py). The native
layout is one compressed .npz per split with flat ragged storage:

    <out>/manifest.json      {"settings": {...}, "date": ..., "splits": [...]}
    <out>/<split>.npz        seqs (N,) unicode, ids (N,) unicode,
                             offsets (N+1,) int64 residue offsets,
                             ang (sum_L, 24) f32, crd (sum_L*14, 3) f32

Loads with plain numpy (no torch dependency on the training path) and mmaps
cleanly for large datasets.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def convert_split(split_data: dict) -> dict:
    seqs = list(split_data["seq"])
    angs = [np.asarray(a, np.float32) for a in split_data["ang"]]
    crds = [np.asarray(c, np.float32) for c in split_data["crd"]]
    ids = list(split_data.get("ids", [f"p{i}" for i in range(len(seqs))]))
    lens = np.array([a.shape[0] for a in angs], np.int64)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return {
        "seqs": np.array(seqs),
        "ids": np.array([str(i) for i in ids]),
        "offsets": offsets,
        "ang": (np.concatenate(angs) if angs
                else np.zeros((0, 24), np.float32)),
        "crd": (np.concatenate(crds) if crds
                else np.zeros((0, 3), np.float32)),
    }


def convert(data: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    splits = [k for k in data
              if isinstance(data[k], dict) and "seq" in data[k]]
    settings = dict(data.get("settings", {}))
    for k, v in list(settings.items()):
        if isinstance(v, np.ndarray):
            settings[k] = v.tolist()
        elif isinstance(v, dict):
            settings[k] = {sk: (sv.tolist() if isinstance(sv, np.ndarray)
                                else sv) for sk, sv in v.items()}
    date = data.get("date")
    if isinstance(date, set):
        date = next(iter(date))
    manifest = {"settings": settings, "date": str(date), "splits": splits}
    for split in splits:
        np.savez_compressed(os.path.join(out_dir, f"{split}.npz"),
                            **convert_split(data[split]))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, default=str)


def export_pt(data: dict, out_path: str) -> None:
    """Reverse conversion: dataset dict -> reference-schema torch .pt
    (interop with the reference's own tooling)."""
    import torch
    torch.save(data, out_path)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("src", help=".pt file or native shard directory")
    p.add_argument("dst", help="output: directory (native) or .pt file")
    args = p.parse_args(argv)
    from protein_transformer_tpu_torch.data.dataset import load_dataset
    data = load_dataset(args.src)
    if args.dst.endswith(".pt"):
        export_pt(data, args.dst)
    else:
        convert(data, args.dst)
    print(f"converted {args.src} -> {args.dst}")


if __name__ == "__main__":
    main()
