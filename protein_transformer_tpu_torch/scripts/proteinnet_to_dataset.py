"""Offline dataset builder: raw ProteinNet + structures -> training dataset.

The port's counterpart of ptt_scripts/proteinnet_to_dataset.py, on the
port's own acquisition, measurement and alignment modules
(``data/acquire.py``, ``data/proteinnet.py``, ``data/align.py``): parse the
raw records, acquire each entry's structure, measure its angles and
coordinates, align them to the ProteinNet mask and assemble the 9-split
dataset dict with its settings and angle means. It is numpy on the host:
nothing here runs on a device.

Structure sources, per ProteinNet ID:
  * <structures>/<pnid>.pdb                         direct per-id file
  * <structures>/<pdbid>.pdb|.cif                   local PDB mirror
  * RCSB download into <structures>                 only with --fetch
  * <targets>/<caspid>.pdb                          CASP test targets
  * --astral summary file                           ASTRAL domain mapping

Split routing: training_<thinning> files -> 'train', validation ->
'valid-<bucket>' by each record's leading '<bucket>#', testing -> 'test'.

Run:
  python -m protein_transformer_tpu_torch.scripts.proteinnet_to_dataset \
      <raw_dir> <structures> out.pt [--targets DIR] [--astral FILE] \
      [--fetch] [--training_set 30] [--max_len 500] [--errors_dir DIR]
"""
from __future__ import annotations

import argparse
import os

from protein_transformer_tpu_torch.data import proteinnet as pn
from protein_transformer_tpu_torch.data.acquire import (
    parse_astral_summary_file)
from protein_transformer_tpu_torch.data.convert import convert, export_pt


def split_router(training_file: str):
    """Map (pnid, source file) -> split name, or None to skip the record."""
    def route(pnid: str, source: str):
        base = os.path.basename(source)
        if base.startswith("training"):
            return "train" if base.endswith(training_file) else None
        if base.startswith("testing"):
            return "test"
        if base.startswith("validation"):
            bucket = pnid.split("#")[0]
            return f"valid-{bucket}" if bucket.isdigit() else "valid-70"
        return None
    return route


def main(argv=None) -> dict:
    """Build the dataset, write it to ``out`` (.pt, else a native
    directory) and return it."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("raw_dir", help="directory of raw ProteinNet text files")
    ap.add_argument("structures", help="per-id PDBs and/or a pdbid cache")
    ap.add_argument("out", help="output dataset (.pt or native dir)")
    ap.add_argument("--targets", default=None,
                    help="CASP targets directory for test-set ids")
    ap.add_argument("--astral", default=None,
                    help="ASTRAL dir.cla summary file")
    ap.add_argument("--fetch", action="store_true",
                    help="download missing PDB/mmCIF entries from RCSB")
    ap.add_argument("--training_set", default="30",
                    help="thinning of the training file to use (30/50/90/...)")
    ap.add_argument("--max_len", type=int, default=500)
    ap.add_argument("--errors_dir", default=None,
                    help="write per-code failure reports here")
    args = ap.parse_args(argv)

    astral_map = (parse_astral_summary_file(args.astral)
                  if args.astral else None)

    # parse every raw file, remembering which file each record came from
    files = [os.path.join(args.raw_dir, f)
             for f in sorted(os.listdir(args.raw_dir))
             if not f.endswith(".ids")]
    route = split_router(args.training_set)
    records, split_of = {}, {}
    for path in files:
        for rec in pn.parse_proteinnet_records(path):
            pnid = rec.pop("id", None)
            if pnid is None:
                continue
            split = route(pnid, path)
            if split is None:
                continue
            records[pnid] = rec
            split_of[pnid] = split

    errors = pn.ProteinErrors()
    data = pn.build_dataset(records, args.structures, split_of.get,
                            max_len=args.max_len, errors=errors,
                            targets_dir=args.targets, astral_map=astral_map,
                            fetch=args.fetch)
    print(errors.summarize())
    if args.errors_dir:
        errors.write_reports(args.errors_dir)

    splits = [v for v in data.values() if isinstance(v, dict) and "seq" in v]
    if args.out.endswith(".pt"):
        export_pt(data, args.out)
    else:
        convert(data, args.out)
    print(f"Wrote {sum(len(v['seq']) for v in splits)} proteins across "
          f"{len(splits)} splits -> {args.out}")
    return data


if __name__ == "__main__":
    main()
