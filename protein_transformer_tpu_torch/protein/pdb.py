"""PDB file export: the port's own copy of
protein_transformer_tpu/protein/pdb.py (numpy only, no torch).

Writes standard 'ATOM' records for an (L*14, 3) or (L, 14, 3) coordinate set
plus a 1-letter sequence, using the per-AA 14-slot atom-name map of
``_ff14sb.ATOM_NAMES_14``. Atoms at empty slots (name '', all-zero, or NaN
coordinates) are skipped. ``tests/test_torch_predict.py`` holds the lines
equal to the JAX package's, string for string.
"""
from __future__ import annotations

import numpy as np

from protein_transformer_tpu_torch.protein import _ff14sb as ff
from protein_transformer_tpu_torch.protein.constants import NUM_PREDICTED_COORDS
from protein_transformer_tpu_torch.protein.vocab import (
    ONE_TO_THREE_LETTER_MAP, VOCAB)


def atom_names_for_seq(seq: str) -> list[list[str]]:
    """Per-residue 14-slot atom names ('' for empty slots)."""
    return [ff.ATOM_NAMES_14[VOCAB[c]] for c in seq]


def _atom_line_parts(res_char: str,
                     chain: str = " ") -> list[tuple[int, str, str]]:
    """Per-(AA, chain) precomputed (slot, prefix, suffix) per atom slot.

    An ATOM record is `"ATOM  " nbr:5d prefix resnum:4d "    " x y z suffix`;
    everything except the atom number, residue number, and coordinates is a
    per-(AA, slot) constant, so formatting each line needs one f-string with
    five interpolations instead of a 14-field .format call.
    """
    parts = []
    res3 = ONE_TO_THREE_LETTER_MAP.get(res_char, "UNK")
    for slot, name in enumerate(ff.ATOM_NAMES_14[VOCAB[res_char]]):
        if not name:
            continue
        # widths: name^4, altloc(1)=' ', res3(3), ' ', chain(1)
        prefix = f"{name:^4s} {res3:3s} {chain[:1] or ' '}"
        # occupancy 1.00, b-factor 0.00, 10 spaces, element>2, charge(2)='  '
        suffix = f"  1.00  0.00          {name[0]:>2s}  "
        parts.append((slot, prefix, suffix))
    return parts


_LINE_PARTS_CACHE: dict = {}


class PdbWriter:
    def __init__(self, coords: np.ndarray, seq: str, chain: str = " "):
        coords = np.asarray(coords, np.float64)
        if coords.ndim == 3:
            coords = coords.reshape(-1, 3)
        n_res, rest = divmod(coords.shape[0], NUM_PREDICTED_COORDS)
        if rest or len(seq) != n_res:
            raise ValueError(f"{coords.shape[0]} atoms do not make "
                             f"{len(seq)} residues of "
                             f"{NUM_PREDICTED_COORDS}")
        self.coords = coords.reshape(n_res, NUM_PREDICTED_COORDS, 3)
        self.seq = seq
        self.chain = chain

    def lines(self, title: str = "pred") -> list[str]:
        out = [f"REMARK  {title}"]
        atom_nbr = 1
        # atom validity in one vectorised pass
        crd = self.coords
        skip = np.isnan(crd).any(-1) | (crd == 0).all(-1)     # (L, 14)
        for res_i, res_char in enumerate(self.seq):
            key = (res_char, self.chain)
            parts = _LINE_PARTS_CACHE.get(key)
            if parts is None:
                parts = _LINE_PARTS_CACHE[key] = \
                    _atom_line_parts(res_char, self.chain)
            resnum = f"{res_i + 1:4d}    "
            row = crd[res_i]
            row_skip = skip[res_i]
            for slot, prefix, suffix in parts:
                if row_skip[slot]:
                    continue
                x, y, z = row[slot]
                out.append(f"ATOM  {atom_nbr:5d} {prefix}{resnum}"
                           f"{x:8.3f}{y:8.3f}{z:8.3f}{suffix}")
                atom_nbr += 1
        out.append("TER")
        out.append("END          ")
        return out

    def save_pdb(self, path: str, title: str = "pred") -> None:
        with open(path, "w") as f:
            f.write("\n".join(self.lines(title)) + "\n")


def parse_pdb_atoms(path: str):
    """Minimal ATOM-record parser (round-trip testing and predict tooling).

    Returns (atom_names, res_names, res_numbers, coords (N,3)).
    """
    names, res_names, res_nums, xyz = [], [], [], []
    with open(path) as f:
        for line in f:
            if not line.startswith("ATOM"):
                continue
            names.append(line[12:16].strip())
            res_names.append(line[17:20].strip())
            res_nums.append(int(line[22:26]))
            xyz.append([float(line[30:38]), float(line[38:46]),
                        float(line[46:54])])
    return names, res_names, res_nums, np.asarray(xyz)
