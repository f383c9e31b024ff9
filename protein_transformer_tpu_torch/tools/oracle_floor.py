"""Irreducible-dRMSD floor of the gen_scale_data distribution.

The port's counterpart of the JAX package's ``tools/oracle_floor.py``, with
the same draws. The scale dataset's coil residues draw psi uniformly
(``gen_scale_data.RAMA``), so even a Bayes-optimal model cannot predict
them from sequence. For each sampled chain this draws TWO independent angle
sets conditioned on the SAME sequence and segment labels (two samples from
the generator's conditional p(structure | sequence)), builds both
structures (``protein/geometry.py``; on a GPU the sidechain kernel) and
reports the pairwise dRMSD (``losses.drmsd_masked``; on a GPU the dRMSD
kernel). A trained model's valid-split dRMSD should be compared against
this number, not 0.

    python -m protein_transformer_tpu_torch.tools.oracle_floor \\
        [--n 20] [--len 150] [--seed 20260819] [--device cpu]

``--device cuda`` (the default) needs a GPU and raises without one.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.losses import drmsd_masked
from protein_transformer_tpu_torch.protein.constants import (
    NUM_PREDICTED_COORDS)
from protein_transformer_tpu_torch.protein.geometry import build_coords_batch
from protein_transformer_tpu_torch.protein.vocab import VOCAB
from protein_transformer_tpu_torch.tools.gen_scale_data import (
    _aa_rotamers, sample_angles, sample_kinds_seq)


def draw_pairs(n, length, seed):
    """(n, 2, L, 12) angle pairs and (n, L) ids, in the JAX tool's draw
    order: per chain its kinds and sequence, then the two angle sets; the
    rotamers from a second rng of the same seed."""
    rng = np.random.default_rng(seed)
    rotamers = _aa_rotamers(np.random.default_rng(seed))
    angs, ids_all = [], []
    for _ in range(n):
        kinds, seq = sample_kinds_seq(rng, length)
        ids = np.array([VOCAB[c] for c in seq], np.int32)
        angs.append([sample_angles(rng, kinds, ids, rotamers),
                     sample_angles(rng, kinds, ids, rotamers)])
        ids_all.append(ids)
    return np.array(angs, np.float32), np.array(ids_all, np.int32)


def floor_values(n, length, seed, device) -> np.ndarray:
    """(n,) dRMSD between the two structures of each chain, all chains
    built in one batch and measured in one call."""
    angs, ids = draw_pairs(n, length, seed)
    with torch.no_grad():
        crd = build_coords_batch(
            torch.from_numpy(angs.reshape(2 * n, length, -1)).to(device),
            torch.from_numpy(np.repeat(ids, 2, axis=0)).to(device))
        crd = crd.reshape(n, 2, length * NUM_PREDICTED_COORDS, 3)
        valid = (torch.linalg.vector_norm(crd, dim=-1) > 1e-8).all(dim=1)
        d = drmsd_masked(crd[:, 0], crd[:, 1], valid)
    return d.cpu().numpy().astype(np.float64)


def summary_line(vals, n, length) -> str:
    """The JAX tool's line."""
    return (f"conditional-resample dRMSD floor (n={n}, L={length}): "
            f"mean {np.mean(vals):.2f} A, median {np.median(vals):.2f}, "
            f"min {np.min(vals):.2f}, max {np.max(vals):.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--len", dest="length", type=int, default=150)
    ap.add_argument("--seed", type=int, default=20260819)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda needs a GPU and raises without one")
    args = ap.parse_args(argv)
    device = cuda_device() if args.device == "cuda" else torch.device("cpu")
    vals = floor_values(args.n, args.length, args.seed, device)
    print(summary_line(vals, args.n, args.length))
    return vals


if __name__ == "__main__":
    main()
