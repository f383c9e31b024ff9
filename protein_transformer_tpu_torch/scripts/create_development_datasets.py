"""Tiny development datasets for overfitting experiments.

The port's counterpart of ptt_scripts/create_development_datasets.py (the
reference's scripts/create_development_datasets.py:17-48): the items of a
list of protein ids, taken from a full dataset into a small one whose
train, valid-* and test splits are the same items, written in the native
shard format (``data/convert.py``). ``--any_split`` searches every split
by id substring (the reference's scripts/extract_processed_ids.py). Numpy
on the host.

Run: python -m protein_transformer_tpu_torch.scripts.create_development_datasets \
         <data> <ids.txt> <out_dir> [--any_split]
"""
from __future__ import annotations

import argparse

from protein_transformer_tpu_torch.data.convert import convert
from protein_transformer_tpu_torch.data.dataset import (
    VALID_SPLITS, load_dataset)


def _every_split_is(small: dict, data: dict) -> dict:
    out = {"train": small, "test": small,
           "settings": data.get("settings", {}), "date": data.get("date")}
    for split in VALID_SPLITS:
        out[f"valid-{split}"] = small
    return out


def make_dev_dataset(data: dict, wanted_ids: list[str]) -> dict:
    """The training items whose id is one of ``wanted_ids`` (else, whose id
    holds one of them: the reference's ids embed chain information) as
    every split of a small dataset."""
    train = data["train"]
    ids = [str(i) for i in train.get("ids", [])]
    keep = [i for i, pid in enumerate(ids) if pid in set(wanted_ids)]
    if not keep:
        keep = [i for i, pid in enumerate(ids)
                if any(w in pid for w in wanted_ids)]
    if not keep:
        raise ValueError("none of the requested ids found in the dataset")
    small = {k: [train[k][i] for i in keep]
             for k in ("seq", "ang", "crd", "ids") if k in train}
    return _every_split_is(small, data)


def extract_ids_dataset(data: dict, wanted_ids: list[str]) -> dict:
    """The items of ANY split whose id holds one of ``wanted_ids``, as
    every split of a small dataset."""
    small = {"seq": [], "ang": [], "crd": [], "ids": []}
    for d in data.values():
        if not isinstance(d, dict) or "seq" not in d:
            continue
        for i, pid in enumerate(d.get("ids", [])):
            if any(w in str(pid) for w in wanted_ids):
                for k in small:
                    if k in d:
                        small[k].append(d[k][i])
    return _every_split_is(small, data)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("data")
    p.add_argument("ids_file")
    p.add_argument("out_dir")
    p.add_argument("--any_split", action="store_true",
                   help="search all splits, not just train")
    args = p.parse_args(argv)
    with open(args.ids_file) as f:
        wanted = [line.strip() for line in f if line.strip()]
    data = load_dataset(args.data)
    out = (extract_ids_dataset if args.any_split else make_dev_dataset)(
        data, wanted)
    convert(out, args.out_dir)
    print(f"wrote {args.out_dir} with {len(out['train']['seq'])} items")
    return out


if __name__ == "__main__":
    main()
