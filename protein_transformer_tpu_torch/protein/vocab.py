"""Amino-acid vocabulary (the port's own copy of
protein_transformer_tpu/protein/vocab.py).

Behavioral parity with the reference vocabulary (reference:
protein/Sequence.py:1-91): the 20 standard amino acids in alphabetical
1-letter-code order get ids 0..19, then pad '_' (20) and unk '?' (21);
optional sos '<' / eos '>' get 22/23. Unknown characters map to unk.

Unlike the reference, ids are FIXED regardless of whether sos/eos are enabled,
so dense chemistry tables can always be indexed by sequence id directly.
(In the reference, sos/eos are only ever appended after pad/unk, so the fixed
assignment is identical to the reference's dynamic one.)
"""
from __future__ import annotations

import numpy as np

STD_AAS = "ACDEFGHIKLMNPQRSTVWY"

ONE_TO_THREE_LETTER_MAP = {
    "A": "ALA", "C": "CYS", "D": "ASP", "E": "GLU", "F": "PHE", "G": "GLY",
    "H": "HIS", "I": "ILE", "K": "LYS", "L": "LEU", "M": "MET", "N": "ASN",
    "P": "PRO", "Q": "GLN", "R": "ARG", "S": "SER", "T": "THR", "V": "VAL",
    "W": "TRP", "Y": "TYR",
}
THREE_TO_ONE_LETTER_MAP = {v: k for k, v in ONE_TO_THREE_LETTER_MAP.items()}

AA_MAP = {aa: i for i, aa in enumerate(STD_AAS)}
AA_MAP.update({ONE_TO_THREE_LETTER_MAP[aa]: i for i, aa in enumerate(STD_AAS)})
AA_MAP_INV = {i: aa for i, aa in enumerate(STD_AAS)}


class ProteinVocabulary:
    """str <-> int codec for amino-acid sequences."""

    pad_char = "_"
    unk_char = "?"
    sos_char = "<"
    eos_char = ">"

    def __init__(self, include_sos_eos: bool = False):
        self.include_sos_eos = include_sos_eos
        chars = list(STD_AAS) + [self.pad_char, self.unk_char]
        if include_sos_eos:
            chars += [self.sos_char, self.eos_char]
        self._char2int = {c: i for i, c in enumerate(chars)}
        self._int2char = {i: c for i, c in enumerate(chars)}
        self.pad_id = self._char2int[self.pad_char]
        self.unk_id = self._char2int[self.unk_char]
        # Byte lookup table for vectorized encoding (str2array): one fancy
        # index replaces a per-character dict loop on the hot collate path.
        self._byte_lut = np.full(256, self.unk_id, np.int32)
        for c, i in self._char2int.items():
            self._byte_lut[ord(c)] = i
        # Parity quirk: when sos/eos are absent from the vocabulary, the
        # reference's sos_id/eos_id resolve to the unk id (Sequence.py:29-30
        # via __getitem__'s unk fallback), and enc-dec sequences are encoded
        # with unk as their sos/eos. We preserve this behavior.
        self.sos_id = self._char2int.get(self.sos_char, self.unk_id)
        self.eos_id = self._char2int.get(self.eos_char, self.unk_id)

    def __len__(self) -> int:
        return len(self._char2int)

    def __contains__(self, aa: str) -> bool:
        return aa in self._char2int

    def __getitem__(self, aa: str) -> int:
        return self._char2int.get(aa, self.unk_id)

    def __repr__(self) -> str:
        return f"ProteinVocabulary[size={len(self)}]"

    def int2char(self, i: int) -> str:
        return self._int2char[i]

    def int2chars(self, i: int) -> str:
        """3-letter code for an amino-acid id."""
        return ONE_TO_THREE_LETTER_MAP[self._int2char[i]]

    def str2ints(self, seq: str, add_sos_eos: bool = False) -> list[int]:
        ids = [self[aa] for aa in seq]
        if add_sos_eos:
            return [self.sos_id] + ids + [self.eos_id]
        return ids

    def ints2str(self, ints, include_sos_eos: bool = False) -> str:
        out = []
        skip = {self.sos_id, self.eos_id, self.pad_id}
        for i in ints:
            i = int(i)
            if include_sos_eos or i not in skip:
                out.append(self._int2char.get(i, self.unk_char))
        return "".join(out)

    def str2array(self, seq: str, add_sos_eos: bool = False) -> np.ndarray:
        """Vectorized str2ints. Unknown / non-ascii characters map to unk
        ('ascii'+'replace' substitutes '?', which is the unk char)."""
        ids = self._byte_lut[
            np.frombuffer(seq.encode("ascii", "replace"), np.uint8)]
        if add_sos_eos:
            return np.concatenate((
                np.array([self.sos_id], np.int32), ids,
                np.array([self.eos_id], np.int32)))
        return ids


# Module-level singleton, as in the reference (Sequence.py:91): 22 ids
# (20 AAs + pad + unk), no distinct sos/eos.
VOCAB = ProteinVocabulary(include_sos_eos=False)
