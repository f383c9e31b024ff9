"""The benchmark's traffic generator: synthetic proteins from a seed.

One general generator for every traffic file (``benchmark/traffic/*.json``
names it under ``generator``). A split is ``n`` proteins whose lengths are
a fixed set, the same for every seed: ``uniform``, min .. max in equal
shares. The seed then orders those lengths and draws, vectorised over proteins:
residue ids uniform over the 20 amino acids; angles near helical and
extended statistics (phi in (-pi, -pi/4), psi and the six chi uniform,
omega pi + N(0, 0.05), the three bond angles 1.94 / 2.03 / 2.13 +
N(0, 0.02)); the true coordinates from the benchmark's own NeRF
(``reference/geometry.py``) on the device in one batched build; and
``missing_atoms`` of the existing atoms marked missing (NaN), besides the
slots a residue's sidechain does not have. So every seed gives the same
work in another order, and the same seed the same proteins bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import geometry

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"
PAD_ID = 20


@dataclasses.dataclass
class Proteins:
    """n proteins padded to the longest: lens (n,), ids (n, Lmax) with
    PAD_ID past each length, sincos (n, Lmax, 24) interleaved [cos, sin],
    crd (n, Lmax, 14, 3) float32 with NaN where an atom is missing."""
    lens: np.ndarray
    ids: np.ndarray
    sincos: np.ndarray
    crd: np.ndarray

    def __len__(self) -> int:
        return len(self.lens)

    def reference_schema(self) -> dict:
        """The split as the original's dataset dict holds it: sequence
        strings, (L, 24) angles and (14 L, 3) coordinates per protein."""
        seqs, angs, crds = [], [], []
        for i, n in enumerate(self.lens):
            seqs.append("".join(AMINO_ACIDS[a] for a in self.ids[i, :n]))
            angs.append(self.sincos[i, :n])
            crds.append(self.crd[i, :n].reshape(-1, 3))
        return {"seq": seqs, "ang": angs, "crd": crds,
                "ids": [f"bench{i}" for i in range(len(self))]}


def fixed_lengths(spec: dict, n: int) -> np.ndarray:
    """The length set of ``spec`` for n proteins (ascending)."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        return lo + (np.arange(n) * (hi - lo + 1)) // n
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def make(spec: dict, rng: np.random.Generator, missing_atoms: float,
         device) -> Proteins:
    """One split of ``spec`` (``n`` and ``lengths``) drawn from ``rng``."""
    n = int(spec["n"])
    lens = rng.permutation(fixed_lengths(spec["lengths"], n))
    lmax = int(lens.max())
    real = np.arange(lmax)[None, :] < lens[:, None]
    ids = rng.integers(0, len(AMINO_ACIDS), (n, lmax))
    ids = np.where(real, ids, PAD_ID).astype(np.int64)
    ang = np.empty((n, lmax, 12), np.float32)
    ang[..., 0] = rng.uniform(-np.pi, -np.pi / 4, (n, lmax))
    ang[..., 1] = rng.uniform(-np.pi, np.pi, (n, lmax))
    omega = np.pi + rng.normal(0, 0.05, (n, lmax))
    ang[..., 2] = np.where(omega > np.pi, omega - 2 * np.pi, omega)
    for col, mean in ((3, 1.94), (4, 2.03), (5, 2.13)):
        ang[..., col] = mean + rng.normal(0, 0.02, (n, lmax))
    ang[..., 6:] = rng.uniform(-np.pi, np.pi, (n, lmax, 6))
    ang[~real] = 0.0
    with torch.no_grad():
        crd = geometry.coords(torch.from_numpy(ang).to(device),
                              torch.from_numpy(ids).to(device)).cpu().numpy()
    n_sc = geometry.SC_NUM_ATOMS[np.minimum(ids, geometry.N_TYPES - 1)]
    exists = (np.arange(14)[None, None, :] < 4 + n_sc[..., None]) \
        & real[..., None]
    missing = rng.random((n, lmax, 14)) < missing_atoms
    crd[~exists | missing] = np.nan
    sincos = np.stack([np.cos(ang), np.sin(ang)], -1).reshape(n, lmax, 24)
    sincos[~real] = np.nan
    return Proteins(lens, ids, sincos.astype(np.float32),
                    crd.astype(np.float32))


def dataset(traffic: dict, seed: int, device) -> tuple[dict, dict]:
    """({split name: Proteins}, the dataset dict the program loads) of a
    traffic file: its ``splits`` ({name: {n, lengths}}), each drawn from
    one generator seeded with ``seed``; the angle means are the train
    split's."""
    rng = np.random.default_rng(seed)
    splits = {name: make(spec, rng, traffic["missing_atoms"], device)
              for name, spec in traffic["splits"].items()}
    data = {name: p.reference_schema() for name, p in splits.items()}
    train = splits["train"]
    real = np.arange(train.sincos.shape[1])[None, :] < train.lens[:, None]
    data["settings"] = {"max_len": int(traffic["max_len"]),
                        "angle_means": train.sincos[real].mean(0)}
    return splits, data
