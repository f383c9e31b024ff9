"""Generate a few-hundred-protein dataset with a LEARNABLE seq->structure map.

The port's counterpart of the JAX package's ``tools/gen_scale_data.py``,
with the same draws: at one seed it gives the same sequences, ids and
angles, bit for bit. The committed dev fixture (``gen_dev_data``) is tiny
and its angles are independent of the sequence, so it can only demonstrate
overfitting. This tool generates a convergence-scale dataset (default 300
train / 40 valid / 40 test chains, 50-250 residues) where structure is
*predictable from sequence*, the property real ProteinNet data has:

- sequences are sampled segment-wise: each secondary-structure segment
  (helix / strand / coil) draws its residues from a kind-specific amino-acid
  distribution (helix-formers A/L/E/M/Q/K vs sheet-formers V/I/Y/F/W/T vs
  breakers G/P/N/D/S -- Chou-Fasman-flavoured), so a sequence window carries
  the information needed to infer the local backbone cluster;
- backbone (phi, psi) come from the segment kind's Ramachandran cluster;
- sidechain chi angles are per-amino-acid rotamer means + small noise, so
  sidechain geometry is learnable from residue identity alone.

A transformer trained on this must learn real sequence->structure inference
(segment typing from context + per-AA rotamers) to improve on held-out
chains. Coordinates are built by ``protein/geometry.py::build_coords_batch``
(on a GPU its sidechain kernel) in length-sorted chunks; the output is the
native shard format the training CLI reads.

    python -m protein_transformer_tpu_torch.tools.gen_scale_data \\
        --out /tmp/scale_data [--device cpu]

``--device cuda`` (the default) needs a GPU and raises without one.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from protein_transformer_tpu_torch.data.convert import convert
from protein_transformer_tpu_torch.data.proteinnet import create_data_dict
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.protein import measure
from protein_transformer_tpu_torch.protein.constants import (
    NUM_PREDICTED_ANGLES, NUM_PREDICTED_COORDS)
from protein_transformer_tpu_torch.protein.geometry import build_coords_batch
from protein_transformer_tpu_torch.protein.vocab import STD_AAS, VOCAB

# kind-specific residue pools (weights within each pool are uniform; the
# pools overlap so the mapping is probabilistic, not a cipher)
POOLS = {
    "H": list("ALEMQKRH") + list("AL"),          # helix formers, A/L enriched
    "E": list("VIYFWTC") + list("VI"),           # sheet formers
    "L": list("GPNDST") + list("G"),             # breakers / turns
}
RAMA = {"H": (-1.00, -0.82, 0.08),               # phi, psi, jitter (rad)
        "E": (-2.43, 2.36, 0.15),
        "L": (None, None, 0.01)}                 # coil: sampled per residue

# one fixed rotamer mean per amino acid for the 6 chi slots: chosen from the
# staggered set so the per-AA signal is unambiguous yet physically plausible
_ROT = np.array([-np.pi / 3, np.pi / 3, np.pi])

# chains built at once, and the lattice their padded length is rounded to
CHUNK = 512
LENGTH_LATTICE = 32


def _aa_rotamers(rng: np.random.Generator) -> np.ndarray:
    """(20, 6) fixed per-AA chi means, drawn once from a seeded rng."""
    return _ROT[rng.integers(0, 3, size=(len(STD_AAS), 6))]


def sample_kinds_seq(rng, length):
    """Segment kinds and the sequence drawn from their pools."""
    kinds, seq = [], []
    while len(kinds) < length:
        k = rng.choice(["H", "E", "L"], p=[0.40, 0.30, 0.30])
        seg = int(rng.integers(4, 13)) if k != "L" else int(rng.integers(2, 6))
        kinds.extend([k] * seg)
        seq.extend(rng.choice(POOLS[k], size=seg))
    return kinds[:length], "".join(seq[:length])


def sample_angles(rng, kinds, ids, rotamers):
    """(L, 12) radians drawn for the segment kinds and residue ids."""
    length = len(kinds)
    ang = np.zeros((length, NUM_PREDICTED_ANGLES), np.float32)
    for i, k in enumerate(kinds):
        phi, psi, jit = RAMA[k]
        if phi is None:
            phi = rng.uniform(-2.8, -0.5)
            psi = rng.uniform(-np.pi, np.pi)
        ang[i, 0] = phi + rng.normal(0, jit)
        ang[i, 1] = psi + rng.normal(0, jit)
    omega = np.pi + rng.normal(0, 0.03, length)
    ang[:, 2] = np.where(omega > np.pi, omega - 2 * np.pi, omega)
    ang[:, 3] = 1.94 + rng.normal(0, 0.017, length)
    ang[:, 4] = 2.03 + rng.normal(0, 0.017, length)
    ang[:, 5] = 2.13 + rng.normal(0, 0.017, length)
    # sidechains: identity-determined rotamer + noise (std AA ids are 0..19)
    ang[:, 6:] = rotamers[ids] + rng.normal(0, 0.10, (length, 6))
    ang[:, 6:] = np.where(ang[:, 6:] > np.pi, ang[:, 6:] - 2 * np.pi,
                          ang[:, 6:])
    return ang


def gen_chain(rng, length, rotamers):
    """(sequence, (L,) int32 ids, (L, 12) float32 radians) of one chain."""
    kinds, seq = sample_kinds_seq(rng, length)
    ids = np.array([VOCAB[c] for c in seq], np.int32)
    return seq, ids, sample_angles(rng, kinds, ids, rotamers)


def draw_split(rng, n, min_len, max_len, rotamers):
    """The lengths and chains of a split: (lengths, seqs, ids, angles)."""
    lengths = rng.integers(min_len, max_len + 1, size=n)
    chains = [gen_chain(rng, int(length), rotamers) for length in lengths]
    return (lengths, [c[0] for c in chains], [c[1] for c in chains],
            [c[2] for c in chains])


def build_chains(ids_list, angs, max_len, device, chunk=CHUNK):
    """(L, 14, 3) float32 coordinates of each chain, built on ``device`` in
    chunks of length-sorted chains (one padded batch at CASP12 scale would
    be 20k x 250; sorting by length keeps padding waste and peak memory
    flat), padded to a lattice of lengths so that the chunks take a handful
    of shapes."""
    lengths = np.array([len(i) for i in ids_list])
    crds: list = [None] * len(lengths)
    order = np.argsort(lengths, kind="stable")
    for c0 in range(0, len(lengths), chunk):
        sel = order[c0:c0 + chunk]
        lmax = min(int(np.ceil(lengths[sel].max() / LENGTH_LATTICE)
                       * LENGTH_LATTICE), max_len)
        ids_pad = np.full((len(sel), lmax), VOCAB.pad_id, np.int32)
        ang_pad = np.zeros((len(sel), lmax, NUM_PREDICTED_ANGLES), np.float32)
        for r, i in enumerate(sel):
            ids_pad[r, :lengths[i]] = ids_list[i]
            ang_pad[r, :lengths[i]] = angs[i]
        with torch.no_grad():
            crd = build_coords_batch(torch.from_numpy(ang_pad).to(device),
                                     torch.from_numpy(ids_pad).to(device))
        crd = crd.cpu().numpy()
        for r, i in enumerate(sel):
            crds[i] = crd[r, :lengths[i]]
    return crds


def build_split(rng, n, min_len, max_len, rotamers, prefix,
                device=torch.device("cpu"), chunk=CHUNK):
    """One split in ``create_data_dict``'s form: sequences, sin/cos
    angles, flattened (14 L, 3) coordinates and ids."""
    lengths, seqs, ids_list, angs = draw_split(rng, n, min_len, max_len,
                                               rotamers)
    crds = build_chains(ids_list, angs, max_len, device, chunk)
    return {"seq": seqs,
            "ang": [measure.angles_to_sincos(a).astype(np.float32)
                    for a in angs],
            "crd": [c.reshape(int(length) * NUM_PREDICTED_COORDS, 3)
                    .astype(np.float32) for c, length in zip(crds, lengths)],
            "ids": [f"{prefix}{i:04d}_1_A" for i in range(n)]}


def generate(n_train, n_eval, min_len, max_len, seed, device) -> dict:
    """The three splits, drawn in the JAX tool's order from one rng."""
    rng = np.random.default_rng(seed)
    rotamers = _aa_rotamers(rng)
    return {name: build_split(rng, n, min_len, max_len, rotamers, prefix,
                              device)
            for name, n, prefix in (("train", n_train, "TRN"),
                                    ("valid-70", n_eval, "VAL"),
                                    ("test", n_eval, "TST"))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="/tmp/scale_data")
    ap.add_argument("--n_train", type=int, default=300)
    ap.add_argument("--n_eval", type=int, default=40)
    ap.add_argument("--min_len", type=int, default=50)
    ap.add_argument("--max_len", type=int, default=250)
    ap.add_argument("--seed", type=int, default=20260819)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda needs a GPU and raises without one")
    args = ap.parse_args(argv)
    device = cuda_device() if args.device == "cuda" else torch.device("cpu")
    splits = generate(args.n_train, args.n_eval, args.min_len, args.max_len,
                      args.seed, device)
    data = create_data_dict(splits, max_len=args.max_len)
    convert(data, args.out)
    n = sum(len(s["seq"]) for s in splits.values())
    res = sum(len(s) for sp in splits.values() for s in sp["seq"])
    print(f"wrote {n} chains ({res} residues) to {args.out}")


if __name__ == "__main__":
    main()
