"""Structure measurement: coordinates -> interior angles (vectorized numpy).

The port's own copy of protein_transformer_tpu/protein/measure.py, on the
port's force-field tables, vocabulary and PDB reader.

Reimplements the reference's ProDy-based measurement layer (reference:
protein/structure_utils.py:97-585) as array operations over the framework's
(L, 14, 3) coordinate representation, with NaN marking missing data
(GLOBAL_PAD_CHAR, structure_utils.py:17). This is the exact inverse of the
on-device builder, enabling angles->coords->angles round-trip testing and a
ProDy-free offline data pipeline (PDB file -> coords via protein.pdb ->
angles here).

Angle layout per residue (12): [phi, psi, omega, n-ca-c, ca-c-n, c-n-ca,
chi0..chi5], conventions:
  phi_i   = dihedral(C_{i-1}, N_i, CA_i, C_i)          (NaN at i=0)
  psi_i   = dihedral(N_i, CA_i, C_i, N_{i+1})          (NaN at last)
  omega_i = dihedral(CA_i, C_i, N_{i+1}, CA_{i+1})     (NaN at last;
            forward convention, matching ProDy calcOmega and the builder's
            use of the *previous* residue's omega when extending the chain,
            StructureBuilder.py:159-163)
  ncac_i  = angle(N_i, CA_i, C_i)
  cacn_i  = angle(CA_i, C_i, N_{i+1})                  (NaN at last)
  cnca_i  = angle(C_i, N_{i+1}, CA_{i+1})              (NaN at last)
  chi_k   = dihedral over the k-th sidechain torsion quad; chi_0 uses the
            previous residue's C (next residue's N for i=0), matching
            compute_sidechain_dihedrals (structure_utils.py:165-202); only
            the leading run of predicted ('p') torsions is measured.
"""
from __future__ import annotations

import numpy as np

from protein_transformer_tpu_torch.protein import _ff14sb as ff
from protein_transformer_tpu_torch.protein.constants import (
    NUM_PREDICTED_ANGLES, NUM_PREDICTED_COORDS, SC_ANGLES_START_POS)
from protein_transformer_tpu_torch.protein.vocab import VOCAB

GLOBAL_PAD_CHAR = np.nan

# Number of *measurable* chi angles per AA: the leading run of 'p' torsions
# (measurement stops at the first planar/inferred torsion,
# structure_utils.py:196-201).
_is_leading_p = (ff.SC_TORSION_TYPE == ff.TORSION_PRED) & \
    (ff.SC_TORSION_PI_OFFSET == 0.0)
N_CHI = np.zeros(ff.SC_TORSION_TYPE.shape[0], np.int32)
for _aa in range(ff.SC_TORSION_TYPE.shape[0]):
    k = 0
    while (k < ff.MAX_SC_ATOMS and k < int(ff.SC_NUM_ATOMS[_aa])
           and _is_leading_p[_aa, k]):
        k += 1
    N_CHI[_aa] = k


def dihedral(p0, p1, p2, p3):
    """Signed dihedral over (..., 3) point arrays, radians in [-pi, pi].

    Same formulation as the reference's numerically-safe get_dihedral
    (structure_utils.py:553-585); NaN inputs propagate to NaN outputs.
    """
    a1 = p1 - p0
    a2 = p2 - p1
    a3 = p3 - p2
    v1 = np.cross(a1, a2)
    v1 = v1 / np.maximum(np.linalg.norm(v1, axis=-1, keepdims=True), 1e-12)
    v2 = np.cross(a2, a3)
    v2 = v2 / np.maximum(np.linalg.norm(v2, axis=-1, keepdims=True), 1e-12)
    sign = np.sign(np.sum(v1 * a3, axis=-1))
    cosine = np.clip(np.sum(v1 * v2, axis=-1), -1.0, 1.0)
    rad = np.arccos(cosine)
    return np.where(sign == 0, rad, rad * sign)


def bond_angle(a, b, c):
    """Angle at b over (..., 3) point arrays, radians."""
    v1 = a - b
    v2 = c - b
    cosine = np.sum(v1 * v2, axis=-1) / np.maximum(
        np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1), 1e-12)
    return np.arccos(np.clip(cosine, -1.0, 1.0))


def measure_backbone_angles(coords: np.ndarray) -> np.ndarray:
    """(L, 14, 3) -> (L, 6): phi, psi, omega, ncac, cacn, cnca."""
    L = coords.shape[0]
    n, ca, c = coords[:, 0], coords[:, 1], coords[:, 2]
    out = np.full((L, 6), GLOBAL_PAD_CHAR)
    if L >= 2:
        out[1:, 0] = dihedral(c[:-1], n[1:], ca[1:], c[1:])       # phi
        out[:-1, 1] = dihedral(n[:-1], ca[:-1], c[:-1], n[1:])    # psi
        out[:-1, 2] = dihedral(ca[:-1], c[:-1], n[1:], ca[1:])    # omega
        out[:-1, 4] = bond_angle(ca[:-1], c[:-1], n[1:])          # cacn
        out[:-1, 5] = bond_angle(c[:-1], n[1:], ca[1:])           # cnca
    out[:, 3] = bond_angle(n, ca, c)                              # ncac
    return out


def measure_sidechain_dihedrals(coords: np.ndarray,
                                seq_ids: np.ndarray) -> np.ndarray:
    """(L, 14, 3), (L,) -> (L, 6) chi angles, NaN beyond the measurable run."""
    L = coords.shape[0]
    out = np.full((L, 6), GLOBAL_PAD_CHAR)
    aa = np.clip(seq_ids, 0, ff.SC_NUM_ATOMS.shape[0] - 1)

    # anchor point per residue: prev C; next N for residue 0
    anchor = np.full((L, 3), GLOBAL_PAD_CHAR)
    if L >= 2:
        anchor[1:] = coords[:-1, 2]
        anchor[0] = coords[1, 0]
    buf = np.concatenate([coords, anchor[:, None, :]], axis=1)  # (L, 15, 3)

    frame = ff.SC_FRAME_IDX[aa]          # (L, 10, 3)
    # residue 0's chi0 frame: (next-N, C, CA) instead of (prev-C, N, CA)
    frame = frame.copy()
    if L >= 1:
        frame[0, 0] = (ff.ANCHOR_IDX, 2, 1)
    n_chi = N_CHI[aa]
    for k in range(6):
        sel = n_chi > k
        if not sel.any():
            continue
        idx = frame[sel, k]               # (M, 3)
        rows = np.nonzero(sel)[0]
        a = buf[rows, idx[:, 0]]
        b = buf[rows, idx[:, 1]]
        c = buf[rows, idx[:, 2]]
        d = buf[rows, 4 + k]
        out[rows, k] = dihedral(a, b, c, d)
    return out


def coords_to_angles(coords: np.ndarray, seq_ids: np.ndarray) -> np.ndarray:
    """Full measurement: (L, 14, 3) + (L,) AA ids -> (L, 12) radians.

    NaN where immeasurable (chain ends, missing atoms). Inverse of
    geometry.build_coords up to the angles the builder consumes.
    """
    bb = measure_backbone_angles(coords)
    sc = measure_sidechain_dihedrals(coords, seq_ids)
    return np.concatenate([bb, sc], axis=1)


def angles_to_sincos(angles: np.ndarray) -> np.ndarray:
    """(..., 12) radians -> (..., 24) interleaved [cos, sin]
    (structure_utils.angle_list_to_sin_cos:97-114)."""
    stacked = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    return stacked.reshape(*angles.shape[:-1], NUM_PREDICTED_ANGLES * 2)


def pdb_to_record(path: str):
    """Parse a PDB file into (seq, coords (L, 14, 3) NaN-marked).

    Replaces the ProDy chain-parsing entry of the offline pipeline for files
    already on disk. Atoms are mapped into the framework's 14-slot layout by
    name; unknown residues/atoms are skipped.
    """
    from protein_transformer_tpu_torch.protein.pdb import parse_pdb_atoms
    from protein_transformer_tpu_torch.protein.vocab import THREE_TO_ONE_LETTER_MAP

    names, res_names, res_nums, xyz = parse_pdb_atoms(path)
    residues: dict[int, dict] = {}
    for nm, rn, num, p in zip(names, res_names, res_nums, xyz):
        if rn not in THREE_TO_ONE_LETTER_MAP:
            continue
        residues.setdefault(num, {"res": THREE_TO_ONE_LETTER_MAP[rn],
                                  "atoms": {}})
        residues[num]["atoms"][nm] = p
    nums = sorted(residues)
    seq = "".join(residues[n]["res"] for n in nums)
    coords = np.full((len(nums), NUM_PREDICTED_COORDS, 3), GLOBAL_PAD_CHAR)
    for i, num in enumerate(nums):
        rec = residues[num]
        slot_names = ff.ATOM_NAMES_14[VOCAB[rec["res"]]]
        for slot, nm in enumerate(slot_names):
            if nm and nm in rec["atoms"]:
                coords[i, slot] = rec["atoms"][nm]
    return seq, coords
