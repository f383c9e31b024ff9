"""Per-dimension nanmean of a dataset's training angles.

The port's counterpart of ptt_scripts/compute_dataset_angle_means.py (the
reference's scripts/compute_dataset_angle_means.py:10-25): the nanmean over
every training angle row, saved as a .npy file, used to initialise the
models' output heads. Numpy on the host.

Run: python -m protein_transformer_tpu_torch.scripts.compute_dataset_angle_means \
         <data> <out.npy>
"""
from __future__ import annotations

import argparse

import numpy as np

from protein_transformer_tpu_torch.data.dataset import load_dataset


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("data")
    p.add_argument("out")
    args = p.parse_args(argv)
    data = load_dataset(args.data)
    all_ang = np.concatenate([np.asarray(a, np.float32)
                              for a in data["train"]["ang"]])
    means = np.nanmean(all_ang, axis=0)
    np.save(args.out, means)
    print(f"wrote {args.out}: {means.round(4).tolist()}")
    return means


if __name__ == "__main__":
    main()
