"""Randomly downsample every split of a dataset.

The port's counterpart of ptt_scripts/downsample_dataset.py (the
reference's scripts/downsample_proteinnet.py:9-48): keep n random items of
each split (or a fraction of them), in their order, and write the result
in the native shard format. Reads the reference .pt format and the native
shard directory alike. Numpy on the host.

Run: python -m protein_transformer_tpu_torch.scripts.downsample_dataset \
         <in> <out_dir> --n 100 [--fraction F] [--seed 0]
"""
from __future__ import annotations

import argparse

import numpy as np

from protein_transformer_tpu_torch.data.convert import convert
from protein_transformer_tpu_torch.data.dataset import load_dataset


def down_sample_split(split: dict, rng, n=None, fraction=None) -> dict:
    """``n`` (or ``fraction`` of the) items of a split, drawn without
    replacement from ``rng`` and kept in their order."""
    total = len(split["seq"])
    keep = n if n is not None else max(1, int(total * fraction))
    keep = min(keep, total)
    idx = sorted(rng.choice(total, size=keep, replace=False))
    return {key: [split[key][i] for i in idx]
            for key in ("seq", "ang", "crd", "ids") if key in split}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("input")
    p.add_argument("output", help="output dir (native format)")
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--fraction", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not (args.n or args.fraction):
        p.error("provide --n or --fraction")
    data = load_dataset(args.input)
    rng = np.random.default_rng(args.seed)
    out = dict(data)
    for split in list(data):
        if isinstance(data[split], dict) and "seq" in data[split]:
            out[split] = down_sample_split(data[split], rng, args.n,
                                           args.fraction)
    convert(out, args.output)
    print(f"wrote {args.output}")
    return out


if __name__ == "__main__":
    main()
