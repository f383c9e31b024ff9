"""Export a training run of the JAX package for the PyTorch port.

Reads ``<run_dir>/checkpoints/<checkpoint>`` (orbax) through the JAX
package's ``CheckpointManager.restore_raw`` and writes, into ``<out_dir>``,
plain files that need neither JAX nor orbax to read:

* ``<checkpoint>.npz``: every parameter as a numpy array under the flat key
  ``params/<flax path>`` (for example
  ``params/params/Encoder_0/EncoderLayer_0/.../kernel``), and ``step``;
* ``<checkpoint>.meta.json``: the checkpoint's JSON sidecar, when it has one;
* ``config.json``: the run's config and angle means, as the trainer wrote it.

The optimizer state is not exported. The port turns the directory into a run
of its own with

    python -m protein_transformer_tpu_torch.training.checkpoint \
        <out_dir> <port_run_dir> [--checkpoint best]

Run: python ptt_scripts/export_checkpoint_npz.py <run_dir> <out_dir>
         [--checkpoint best]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, ".")


def flatten(tree, prefix: str):
    """("a/b/c", leaf) for every leaf of nested dicts."""
    for key, val in tree.items():
        name = f"{prefix}/{key}"
        if isinstance(val, dict):
            yield from flatten(val, name)
        else:
            yield name, np.asarray(val)


def export_run(run_dir: str, out_dir: str, modifier: str = "best") -> str:
    """Write ``<out_dir>/{config.json,<modifier>.npz[,<modifier>.meta.json]}``
    from the run in ``run_dir``; returns the path of the ``.npz``."""
    from protein_transformer_tpu.training.checkpoint import CheckpointManager
    result = CheckpointManager(
        os.path.join(run_dir, "checkpoints")).restore_raw(modifier)
    if result is None:
        raise FileNotFoundError(
            f"no '{modifier}' checkpoint in {run_dir}/checkpoints")
    arrays, meta = result
    os.makedirs(out_dir, exist_ok=True)
    flat = dict(flatten(arrays["params"], "params"))
    flat["step"] = np.asarray(arrays["step"])
    path = os.path.join(out_dir, modifier + ".npz")
    np.savez(path, **flat)
    if meta:
        with open(os.path.join(out_dir, modifier + ".meta.json"), "w") as f:
            json.dump(meta, f, default=float)
    shutil.copyfile(os.path.join(run_dir, "config.json"),
                    os.path.join(out_dir, "config.json"))
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_dir")
    p.add_argument("out_dir")
    p.add_argument("--checkpoint", default="best")
    args = p.parse_args(argv)
    print(export_run(args.run_dir, args.out_dir, args.checkpoint))


if __name__ == "__main__":
    main()
