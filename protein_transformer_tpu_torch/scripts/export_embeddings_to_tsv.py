"""Export a trained model's amino-acid embedding table as TSV files.

The port's counterpart of ptt_scripts/export_embeddings_to_tsv.py:
``vectors.tsv`` and ``labels.tsv`` for the TensorFlow Embedding Projector,
from a run of the port's training CLI (or one imported from the JAX
package), loaded by ``predict.load_run``. The table is the one the JAX
script finds: the first two-dimensional parameter, in flax's order, whose
flax path names an embedding, in flax's layout. The model is loaded onto
the GPU unless ``--device cpu`` asks for the CPU; without a GPU ``--device
cuda`` raises.

Run: python -m protein_transformer_tpu_torch.scripts.export_embeddings_to_tsv \
         <run_dir> [--out dir] [--checkpoint best] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
from torch import nn

from protein_transformer_tpu_torch.models.flax_import import (
    flax_names, to_flax_layout)
from protein_transformer_tpu_torch.predict import load_run
from protein_transformer_tpu_torch.protein.vocab import VOCAB


def find_embedding(model: nn.Module) -> np.ndarray:
    """The (vocab, d_model) embedding table of ``model``."""
    params = dict(model.named_parameters())
    for name, path in sorted(flax_names(model).items(),
                             key=lambda kv: kv[1].split("/")):
        if "embedding" in path.lower() and params[name].ndim == 2:
            return to_flax_layout(params[name].detach().cpu().numpy(), path)
    raise ValueError("no embedding table found (linear-input models have none)")


def main(argv=None) -> tuple[str, str]:
    """Write the two files; returns their paths."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir")
    p.add_argument("--out", default=None)
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    _cfg, model = load_run(args.run_dir, args.checkpoint,
                           device=None if args.device == "cuda" else "cpu")
    emb = find_embedding(model)
    out_dir = args.out or args.run_dir
    os.makedirs(out_dir, exist_ok=True)
    vec_path = os.path.join(out_dir, "vectors.tsv")
    lab_path = os.path.join(out_dir, "labels.tsv")
    with open(vec_path, "w") as f:
        for row in emb:
            f.write("\t".join(f"{x:.6f}" for x in row) + "\n")
    with open(lab_path, "w") as f:
        for i in range(emb.shape[0]):
            f.write(VOCAB.int2char(i) if i < len(VOCAB) else f"id{i}")
            f.write("\n")
    print(vec_path)
    print(lab_path)
    return vec_path, lab_path


if __name__ == "__main__":
    main()
