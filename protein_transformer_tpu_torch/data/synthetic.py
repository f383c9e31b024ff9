"""Synthetic dataset generation (reference-schema dict) for tests and smoke
runs.

Port of protein_transformer_tpu/data/synthetic.py: random sequences, angles
near helical/extended statistics, coordinates built from the angles by the
port's geometry, missing atoms NaN-marked like the reference's storage. It
draws from ``numpy.random.default_rng(seed)`` in the JAX package's order, so
one seed gives the same sequences, angles and missing-atom pattern in both
packages; coordinates agree to fp32 rounding of the two NeRF builders.
"""
from __future__ import annotations

import numpy as np
import torch

from protein_transformer_tpu_torch.protein import _ff14sb as ff
from protein_transformer_tpu_torch.protein.constants import (
    NUM_PREDICTED_ANGLES, NUM_PREDICTED_COORDS)
from protein_transformer_tpu_torch.protein.vocab import STD_AAS, VOCAB
from protein_transformer_tpu_torch.data.dataset import VALID_SPLITS
from protein_transformer_tpu_torch.protein.geometry import build_coords_batch


def random_angles(rng: np.random.Generator, length: int) -> np.ndarray:
    ang = np.zeros((length, NUM_PREDICTED_ANGLES), np.float32)
    ang[:, 0] = rng.uniform(-np.pi, -np.pi / 4, length)
    ang[:, 1] = rng.uniform(-np.pi, np.pi, length)
    omega = np.pi + rng.normal(0, 0.05, length)
    ang[:, 2] = np.where(omega > np.pi, omega - 2 * np.pi, omega)
    ang[:, 3] = 1.94 + rng.normal(0, 0.02, length)
    ang[:, 4] = 2.03 + rng.normal(0, 0.02, length)
    ang[:, 5] = 2.13 + rng.normal(0, 0.02, length)
    ang[:, 6:] = rng.uniform(-np.pi, np.pi, (length, 6))
    return ang.astype(np.float32)


def sidechain_case(rng: np.random.Generator, bsz: int, length: int,
                   physical: bool) -> tuple[np.ndarray, np.ndarray]:
    """(angles (B, L, 12) float32, ids (B, L) int32) for holding a sidechain
    build against another: every amino acid appears (where B * L >= 20), and
    every row but the first ends in padding (pad id, zero angles) where
    L > 2. physical draws ``random_angles``; otherwise every angle is
    uniform in (-pi, pi), as an untrained model emits them."""
    if physical:
        ang = np.stack([random_angles(rng, length) for _ in range(bsz)])
    else:
        ang = rng.uniform(-np.pi, np.pi,
                          (bsz, length, NUM_PREDICTED_ANGLES)).astype(
                              np.float32)
    ids = rng.permutation(bsz * length) % len(STD_AAS)
    ids = ids.reshape(bsz, length).astype(np.int32)
    for row in range(1, bsz):
        n_pad = int(rng.integers(1, max(2, length // 4)))
        if length > 2:
            ids[row, length - n_pad:] = VOCAB.pad_id
            ang[row, length - n_pad:] = 0.0
    return ang, ids


# ids outside the force-field table's 24 rows, which the build clamps
OUT_OF_TABLE_IDS = (-1, 24, 99)


def with_every_type(rng: np.random.Generator, ids: np.ndarray) -> np.ndarray:
    """A copy of ``ids`` in which random real (not padding) positions hold
    every row of the force-field table (0..23: the 20 amino acids, pad,
    unk, sos, eos) and ``OUT_OF_TABLE_IDS``; needs 27 real positions.
    Padding keeps its zero angles, whose collinear frames no amino acid
    should get."""
    extra = np.r_[np.arange(ff.SC_NUM_ATOMS.shape[0]), OUT_OF_TABLE_IDS]
    out = ids.copy()
    real = np.flatnonzero(ids != VOCAB.pad_id)
    out.flat[rng.choice(real, extra.size, replace=False)] = extra
    return out


def atom_mask_case(rng: np.random.Generator, bsz: int, n: int,
                   missing_atoms: float = 0.02) -> np.ndarray:
    """(B, n) bool atom masks as the training step builds them for its
    full-atom dRMSD: atoms in residue-major order, NUM_PREDICTED_COORDS
    slots a residue, of which slots 0 .. 3 + SC_NUM_ATOMS of the residue's
    random amino acid are real; ``missing_atoms`` of them missing; each
    protein ends in a padded tail of a random length up to a quarter of the
    rows (n need not be a multiple of the slots: the last residue is cut);
    the last protein is all padding, as a batch padded to its bucket."""
    n_res = -(-n // NUM_PREDICTED_COORDS)
    aa = rng.integers(0, len(STD_AAS), (bsz, n_res))
    n_sc = np.asarray(ff.SC_NUM_ATOMS)[[VOCAB[c] for c in STD_AAS]][aa]
    slot = np.arange(n_res * NUM_PREDICTED_COORDS) % NUM_PREDICTED_COORDS
    res = np.arange(n_res * NUM_PREDICTED_COORDS) // NUM_PREDICTED_COORDS
    mask = (slot[None] < 4 + n_sc[:, res])[:, :n]
    mask &= rng.random((bsz, n)) >= missing_atoms
    for row in range(bsz):
        tail = int(rng.integers(0, n_res // 4 + 1))
        mask[row, (n_res - tail) * NUM_PREDICTED_COORDS:] = False
    mask[-1] = False
    return np.ascontiguousarray(mask)


def _make_split(rng: np.random.Generator, n: int, min_len: int, max_len: int,
                missing_atoms: float, device: torch.device):
    lengths = rng.integers(min_len, max_len + 1, size=n)
    seqs = ["".join(rng.choice(list(STD_AAS), size=l)) for l in lengths]
    ids_pad = np.full((n, max_len), VOCAB.pad_id, np.int32)
    ang_pad = np.zeros((n, max_len, NUM_PREDICTED_ANGLES), np.float32)
    for i, (s, l) in enumerate(zip(seqs, lengths)):
        ids_pad[i, :l] = [VOCAB[c] for c in s]
        ang_pad[i, :l] = random_angles(rng, l)
    # one padded batched build for the whole split
    with torch.no_grad():
        crd_all = build_coords_batch(
            torch.from_numpy(ang_pad).to(device),
            torch.from_numpy(ids_pad).to(device)).cpu().numpy()

    angs, crds = [], []
    for i, l in enumerate(lengths):
        crd = crd_all[i, :l].reshape(l * NUM_PREDICTED_COORDS, 3).copy()
        n_sc = ff.SC_NUM_ATOMS[ids_pad[i, :l]]
        slot = np.tile(np.arange(NUM_PREDICTED_COORDS), l)
        res = np.repeat(np.arange(l), NUM_PREDICTED_COORDS)
        missing = slot >= (4 + n_sc[res])
        if missing_atoms > 0:
            missing |= rng.random(len(crd)) < missing_atoms
        crd[missing] = np.nan
        a = ang_pad[i, :l]
        sincos = np.stack([np.cos(a), np.sin(a)], -1).reshape(l, -1)
        angs.append(sincos.astype(np.float32))
        crds.append(crd.astype(np.float32))
    return {"seq": seqs, "ang": angs, "crd": crds,
            "ids": [f"syn{i}" for i in range(n)]}


def make_dataset(n_train: int = 32, n_eval: int = 8,
                 min_len: int = 8, max_len: int = 64,
                 seed: int = 0, missing_atoms: float = 0.02,
                 device: torch.device = torch.device("cpu")) -> dict:
    """A reference-schema dataset dict with all 9 splits; coordinates are
    built on ``device``."""
    rng = np.random.default_rng(seed)
    data = {"train": _make_split(rng, n_train, min_len, max_len,
                                 missing_atoms, device),
            "test": _make_split(rng, n_eval, min_len, max_len,
                                missing_atoms, device)}
    for split in VALID_SPLITS:
        data[f"valid-{split}"] = _make_split(rng, n_eval, min_len, max_len,
                                             missing_atoms, device)
    all_ang = np.concatenate(data["train"]["ang"])
    angle_means = np.nanmean(all_ang, axis=0)
    data["settings"] = {"max_len": max_len, "pad_char": 0,
                        "angle_means": angle_means.astype(np.float32)}
    data["date"] = "synthetic"
    return data
