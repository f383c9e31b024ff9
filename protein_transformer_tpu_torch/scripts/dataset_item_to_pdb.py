"""Write a dataset item's true structure (and, with --rebuild, its
angle-rebuilt counterpart) to PDB files.

The port's counterpart of ptt_scripts/dataset_item_to_pdb.py: inspect one
stored protein without training anything. ``--rebuild`` rebuilds the
coordinates from the stored angles through the port's geometry
(``protein/geometry.py``: the NeRF backbone and the sidechain kernel K2a on
a GPU), which checks the dataset's self-consistency. The rebuild runs on the
GPU unless ``--device cpu`` asks for the CPU; without a GPU ``--device
cuda`` raises.

Run: python -m protein_transformer_tpu_torch.scripts.dataset_item_to_pdb \
         <data> [--split train] [--idx 0] [--out <id>_true.pdb] [--rebuild] \
         [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from protein_transformer_tpu_torch.data.dataset import load_dataset
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.protein.constants import (
    NUM_PREDICTED_COORDS)
from protein_transformer_tpu_torch.protein.geometry import (
    build_coords, inverse_trig_transform)
from protein_transformer_tpu_torch.protein.pdb import PdbWriter
from protein_transformer_tpu_torch.protein.vocab import VOCAB


def rebuild_coords(sincos: np.ndarray, seq: str,
                   device: torch.device) -> np.ndarray:
    """(L, 14, 3) coordinates built on ``device`` from a stored (L, 24)
    sin/cos angle array (missing angles, NaN, count as zero pairs)."""
    ang = inverse_trig_transform(torch.from_numpy(
        np.nan_to_num(np.asarray(sincos, np.float32))).to(device))
    ids = torch.tensor([VOCAB[c] for c in seq], dtype=torch.int64,
                       device=device)
    with torch.no_grad():
        return build_coords(ang, ids).cpu().numpy()


def main(argv=None) -> list[str]:
    """Write the PDB files; returns their paths."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("data")
    p.add_argument("--split", default="train")
    p.add_argument("--idx", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--rebuild", action="store_true",
                   help="also rebuild coordinates from the stored angles")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where --rebuild builds (cuda: the GPU, and raise "
                        "without one)")
    args = p.parse_args(argv)

    split = load_dataset(args.data)[args.split]
    seq = split["seq"][args.idx]
    crd = np.asarray(split["crd"][args.idx], np.float32)
    pid = split.get("ids", [f"item{args.idx}"] * (args.idx + 1))[args.idx]
    out = args.out or f"{pid}_true.pdb"
    PdbWriter(crd.reshape(-1, NUM_PREDICTED_COORDS, 3),
              seq).save_pdb(out, title=f"true {pid}")
    print(out)
    paths = [out]

    if args.rebuild:
        device = (cuda_device() if args.device == "cuda"
                  else torch.device("cpu"))
        rebuilt = rebuild_coords(split["ang"][args.idx], seq, device)
        out2 = out.replace("_true.pdb", "_rebuilt.pdb")
        PdbWriter(rebuilt, seq).save_pdb(out2, title=f"rebuilt {pid}")
        print(out2)
        paths.append(out2)
    return paths


if __name__ == "__main__":
    main()
