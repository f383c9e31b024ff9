"""Offline ProteinNet pipeline: raw records -> measured dataset dict.

The port's own copy of protein_transformer_tpu/data/proteinnet.py, on the
port's measurement, alignment and acquisition modules; its worker pool
starts its processes by spawning them (the caller may hold threads).

Host-side (CPU, numpy) rebuild of the reference's offline tooling:
* raw ProteinNet text parsing (reference: scripts/proteinnet_parsing.py:26-64,
  record sections [ID]/[PRIMARY]/[EVOLUTIONARY]/[SECONDARY]/[TERTIARY]/[MASK]);
* the preprocessing failure taxonomy with cross-process-safe integer codes,
  counting and error-file reports (scripts/proteinnet_errors.py:3-86);
* mask alignment of observed (structure-derived) residues onto the
  ProteinNet primary sequence (scripts/align_dataset_to_proteinnet.py
  fast path + contig search), NaN-filling unobserved positions;
* dataset assembly: ascending length sort, sin/cos transform, angle means,
  histogram bin precomputation, settings/date metadata
  (scripts/proteinnet2pytorch.py:211-250,253-293).

Structure measurement itself is ProDy-free: PDB files on disk are parsed by
``protein.pdb`` / measured by ``protein.measure``. (Fetching structures from
the PDB requires network access and sits outside the framework, as the
cluster scripts did for the reference.)
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
from typing import Iterator, Optional

import numpy as np

from protein_transformer_tpu_torch.protein import measure
from protein_transformer_tpu_torch.protein.constants import NUM_PREDICTED_COORDS
from protein_transformer_tpu_torch.protein.structure_exceptions import (
    ContigMultipleMatchingError, CoordsetIndexError, MaskAlignmentError,
    MissingAtomsError, MissingFileError, NanValuesError,
    NonStandardAminoAcidError, NoneStructureError, SequenceError,
    ShortStructureError, StructureError)

# ---------------------------------------------------------------- errors

ERROR_CODES = (
    ("SEQUENCE_ERROR", "Sequence could not be obtained or did not match."),
    ("NONSTANDARD_AA", "Structure contains a non-standard amino acid."),
    ("MISSING_ATOMS", "Atoms required for measurement are missing."),
    ("NONE_STRUCTURE", "Structure could not be parsed."),
    ("SHORT_STRUCTURE", "Structure is too short."),
    ("CONTIG_MULTIPLE_MATCH", "Contig matches target in multiple places."),
    ("MASK_MISMATCH", "Observed residues disagree with the mask."),
    ("MISSING_FILE", "No structure file available for this id."),
    ("NAN_VALUES", "Measured data contained NaN/inf-only entries."),
    ("PARSING_ERROR", "Raw record could not be parsed."),
    ("COORDSET_INDEX", "Model index exceeds the structure's coordsets."),
    ("UNKNOWN", "Unclassified failure."),
)
ERROR_NAME_TO_CODE = {name: i for i, (name, _d) in enumerate(ERROR_CODES)}

# order matters: subclasses (MissingFileError < NoneStructureError) must
# be matched before their parents
_EXCEPTION_TO_ERROR = {
    CoordsetIndexError: "COORDSET_INDEX",
    NanValuesError: "NAN_VALUES",
    SequenceError: "SEQUENCE_ERROR",
    NonStandardAminoAcidError: "NONSTANDARD_AA",
    MissingAtomsError: "MISSING_ATOMS",
    MissingFileError: "MISSING_FILE",
    NoneStructureError: "NONE_STRUCTURE",
    ShortStructureError: "SHORT_STRUCTURE",
    ContigMultipleMatchingError: "CONTIG_MULTIPLE_MATCH",
    MaskAlignmentError: "MASK_MISMATCH",
}


class ProteinErrors:
    """Failure counter keyed by integer code, mergeable across workers
    (scripts/proteinnet_errors.py:22-86)."""

    def __init__(self):
        self.counts: dict[int, list[str]] = {}

    def code_for_exception(self, exc: Exception) -> int:
        for etype, name in _EXCEPTION_TO_ERROR.items():
            if isinstance(exc, etype):
                return ERROR_NAME_TO_CODE[name]
        return ERROR_NAME_TO_CODE["UNKNOWN"]

    def record(self, pnid: str, code: int) -> None:
        self.counts.setdefault(code, []).append(pnid)

    def merge(self, other: "ProteinErrors") -> None:
        for code, ids in other.counts.items():
            self.counts.setdefault(code, []).extend(ids)

    def total(self) -> int:
        return sum(len(v) for v in self.counts.values())

    def summarize(self) -> str:
        lines = [f"{self.total()} preprocessing failures:"]
        for code in sorted(self.counts):
            name, desc = ERROR_CODES[code]
            lines.append(f"  {name} ({len(self.counts[code])}): {desc}")
        return "\n".join(lines)

    def write_reports(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        for code, ids in self.counts.items():
            name = ERROR_CODES[code][0]
            with open(os.path.join(directory, f"{name}.txt"), "w") as f:
                f.write("\n".join(ids) + "\n")


# ---------------------------------------------------------------- parsing

_DSSP = {"L": 0, "H": 1, "B": 2, "E": 3, "G": 4, "I": 5, "T": 6, "S": 7}


def parse_proteinnet_records(path: str,
                             include_tertiary: bool = False) -> Iterator[dict]:
    """Stream records from a raw ProteinNet text file.

    Section layout per the ProteinNet release format (cf. the reference's
    reader, scripts/proteinnet_parsing.py:26-64): [ID], [PRIMARY],
    [EVOLUTIONARY] (21 rows), [SECONDARY], [TERTIARY] (3 rows, picometers),
    [MASK] ('+'/'-'), blank line terminates a record.
    """
    rec: dict = {}
    with open(path) as f:
        section = None
        rows_left = 0
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("[") and line.endswith("]"):
                section = line[1:-1]
                rows_left = {"EVOLUTIONARY": 21, "TERTIARY": 3}.get(section, 1)
                if section == "TERTIARY" and not include_tertiary:
                    section = "SKIP_TERTIARY"
                    rows_left = 3
                if section in ("EVOLUTIONARY", "TERTIARY"):
                    rec.setdefault(section.lower(), [])
                continue
            if line == "":
                if rec:
                    yield rec
                rec = {}
                section = None
                continue
            if section is None or rows_left <= 0:
                continue
            if section == "ID":
                rec["id"] = line
            elif section == "PRIMARY":
                rec["primary"] = line
            elif section == "EVOLUTIONARY":
                rec["evolutionary"].append([float(x) for x in line.split()])
            elif section == "SECONDARY":
                rec["secondary"] = [_DSSP.get(c, 0) for c in line]
            elif section == "TERTIARY":
                rec["tertiary"].append([float(x) for x in line.split()])
            elif section == "SKIP_TERTIARY":
                pass
            elif section == "MASK":
                rec["mask"] = [1 if c == "+" else 0 for c in line]
            rows_left -= 1
    if rec:
        yield rec


def _parse_one_raw_file(path_outdir: tuple) -> dict:
    """Parse one raw ProteinNet file (module-level so it pickles for
    multiprocessing.Pool workers)."""
    path, out_dir = path_outdir
    recs = {}
    ids = []
    for rec in parse_proteinnet_records(path):
        rid = rec.pop("id", None)
        if rid is None:
            continue
        recs[rid] = rec
        ids.append(rid)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(
                out_dir, os.path.basename(path) + ".ids"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return recs


def parse_raw_proteinnet(input_dir: str, out_dir: Optional[str] = None,
                         n_workers: int = 0) -> dict[str, dict]:
    """Parse every raw file in a directory -> {id: record}; optionally write
    per-file .ids listings (scripts/proteinnet_parsing.py:66-115)."""
    files = [os.path.join(input_dir, f) for f in sorted(os.listdir(input_dir))
             if not f.endswith(".ids")]
    jobs = [(path, out_dir) for path in files]
    all_recs: dict[str, dict] = {}
    if n_workers > 1:
        with multiprocessing.get_context("spawn").Pool(n_workers) as pool:
            for recs in pool.map(_parse_one_raw_file, jobs):
                all_recs.update(recs)
    else:
        for job in jobs:
            all_recs.update(_parse_one_raw_file(job))
    return all_recs


# ------------------------------------------------------------- alignment

def align_observed_to_mask(primary: str, mask: list[int], observed_seq: str,
                           observed_ang: np.ndarray,
                           observed_crd: np.ndarray):
    """Scatter observed per-residue data into full-length NaN-padded arrays.

    Fast path (align_dataset_to_proteinnet.can_be_directly_merged): the
    observed sequence equals primary restricted to mask==1. Fallbacks, in
    order: the observed sequence as a single unambiguous contig of primary
    (ambiguity raises ContigMultipleMatchingError); then gap-scored
    Needleman-Wunsch repair deriving a corrected mask for multi-contig
    mismatches (align_dataset_to_proteinnet.py:16-77 behavior, see
    data/align.py). No embedding at all raises MaskAlignmentError.
    Returns (ang (L, 12), crd (L*14, 3)) NaN-filled outside the mask.
    """
    from protein_transformer_tpu_torch.data.align import compute_alignment_mask

    L = len(primary)
    mask = list(mask) if mask is not None else [1] * L
    if len(mask) != L:
        raise MaskAlignmentError("mask/primary length mismatch")
    sel = [i for i, m in enumerate(mask) if m]
    masked_seq = "".join(primary[i] for i in sel)

    if masked_seq == observed_seq:
        positions = sel
    else:
        first = primary.find(observed_seq)
        if first >= 0:
            if primary.find(observed_seq, first + 1) >= 0:
                raise ContigMultipleMatchingError(observed_seq[:20])
            positions = list(range(first, first + len(observed_seq)))
        else:
            repaired = compute_alignment_mask(primary, observed_seq)
            if repaired is None:
                raise MaskAlignmentError(
                    "observed residues cannot be embedded in the primary "
                    "sequence")
            positions = [i for i, c in enumerate(repaired) if c == "+"]

    ang = np.full((L, observed_ang.shape[1]), np.nan, np.float32)
    crd = np.full((L * NUM_PREDICTED_COORDS, 3), np.nan, np.float32)
    obs_crd = observed_crd.reshape(-1, NUM_PREDICTED_COORDS, 3)
    for j, pos in enumerate(positions):
        ang[pos] = observed_ang[j]
        crd[pos * NUM_PREDICTED_COORDS:(pos + 1) * NUM_PREDICTED_COORDS] = \
            obs_crd[j]
    return ang, crd


# --------------------------------------------------------------- builder

MIN_LENGTH = 2


def measure_structure(seq: str, coords: np.ndarray,
                      min_length: int = MIN_LENGTH, origin: str = ""):
    """(seq, (L, 14, 3) NaN-marked coords) -> (seq, angles, flat coords)."""
    if len(seq) < min_length:
        raise ShortStructureError(f"{origin}: {len(seq)} residues")
    ang = measure.coords_to_angles(coords, np.array(
        [measure.VOCAB[c] for c in seq], np.int32))
    crd = coords.reshape(-1, 3)
    return seq, ang.astype(np.float32), crd.astype(np.float32)


def measure_structure_file(pdb_path: str, min_length: int = MIN_LENGTH):
    """PDB file -> (seq, angles (L, 12), coords (L*14, 3)), NaN-marked."""
    if not os.path.exists(pdb_path):
        raise NoneStructureError(pdb_path)
    seq, coords = measure.pdb_to_record(pdb_path)
    return measure_structure(seq, coords, min_length, origin=pdb_path)


def resolve_structure(pnid: str, structure_dir: str,
                      targets_dir: Optional[str] = None,
                      astral_map: Optional[dict] = None,
                      fetch: bool = False):
    """pnid -> (seq, (L, 14, 3) coords): per-id file if present, else the
    full acquisition route (PDB/mmCIF cache or RCSB fetch + model/chain
    selection, data/acquire.py; reference proteinnet2pytorch.py:35-114)."""
    direct = os.path.join(structure_dir, f"{pnid}.pdb")
    if os.path.exists(direct):
        return measure.pdb_to_record(direct)
    from protein_transformer_tpu_torch.data.acquire import (
        get_chain_from_proteinnetid)
    return get_chain_from_proteinnetid(pnid, structure_dir,
                                       targets_dir=targets_dir,
                                       astral_map=astral_map, fetch=fetch)


def build_entry(record: dict, pdb_path: Optional[str] = None,
                structure: Optional[tuple] = None, origin: str = ""):
    """One ProteinNet record + structure -> (seq, sincos, crd).

    structure: pre-resolved (seq, (L, 14, 3) coords) from resolve_structure;
    pdb_path: legacy direct-file entry."""
    if structure is not None:
        seq, ang, crd = measure_structure(*structure, origin=origin)
    else:
        seq, ang, crd = measure_structure_file(pdb_path)
    primary = record.get("primary", seq)
    ang_full, crd_full = align_observed_to_mask(
        primary, record.get("mask"), seq, ang, crd)
    if not np.isfinite(ang_full).any():
        raise NanValuesError("no finite measured angles")
    # cos/sin of NaN are NaN, so the missing-angle markers survive the trig
    # transform as-is
    sincos = measure.angles_to_sincos(ang_full)
    return primary, sincos.astype(np.float32), crd_full


def compute_angle_means(angs: list[np.ndarray]) -> np.ndarray:
    """nanmean over all training angle rows
    (scripts/proteinnet2pytorch.py:253-257).

    A sincos column that is NaN across the whole training set (e.g. a chi
    angle no training protein carries) nanmeans to NaN, which would poison
    the model's angle-mean output bias (arctanh(NaN)); such columns fall
    back to 0.
    """
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # mean of empty slice
        means = np.nanmean(np.concatenate(angs), axis=0)
    return np.nan_to_num(means).astype(np.float32)


def create_data_dict(splits: dict[str, dict], max_len: int = 500) -> dict:
    """Assemble the final dataset dict (proteinnet2pytorch.py:211-250):
    ascending length sort per split, train angle means, settings, date."""
    out: dict = {}
    for name, split in splits.items():
        order = np.argsort([len(s) for s in split["seq"]])
        out[name] = {k: [split[k][i] for i in order]
                     for k in ("seq", "ang", "crd", "ids") if k in split}
    angle_means = compute_angle_means(out["train"]["ang"]) \
        if out.get("train", {}).get("ang") else np.zeros(24, np.float32)
    lens = [len(s) for s in out.get("train", {}).get("seq", [])]
    bins = np.histogram(lens, bins="auto") if lens else None
    out["settings"] = {
        "max_len": max_len,
        "pad_char": 0,
        "angle_means": angle_means,
        "bin_data": {"counts": bins[0].tolist(),
                     "edges": bins[1].tolist()} if bins else None,
    }
    out["date"] = datetime.date.today().isoformat()
    return out


def build_dataset(records: dict[str, dict], structure_dir: str,
                  split_of_id, max_len: int = 500,
                  errors: Optional[ProteinErrors] = None,
                  targets_dir: Optional[str] = None,
                  astral_map: Optional[dict] = None,
                  fetch: bool = False) -> dict:
    """Measure + align every record; returns the dataset dict.

    records: {pnid: proteinnet record}; structure_dir contains either
    <pnid>.pdb files or a <pdbid>.pdb/.cif cache for the acquisition route
    (RCSB download with fetch=True); split_of_id maps a pnid to its split
    name; targets_dir holds CASP target PDBs for test-set ids; astral_map is
    the parsed ASTRAL summary mapping.
    """
    errors = errors if errors is not None else ProteinErrors()
    splits: dict[str, dict] = {}
    for pnid, rec in records.items():
        split = split_of_id(pnid)
        if split is None:
            continue
        try:
            try:
                structure = resolve_structure(
                    pnid, structure_dir, targets_dir=targets_dir,
                    astral_map=astral_map, fetch=fetch)
            except NoneStructureError as e:
                # MissingFileError -> MISSING_FILE; genuine parse/model/
                # download failures -> NONE_STRUCTURE
                errors.record(pnid, errors.code_for_exception(e))
                continue
            except KeyError:
                # an id with no ASTRAL mapping has no file to find
                errors.record(pnid, ERROR_NAME_TO_CODE["MISSING_FILE"])
                continue
            except ValueError:
                # unrecognized id / chain-spec formats
                errors.record(pnid, ERROR_NAME_TO_CODE["PARSING_ERROR"])
                continue
            seq, sincos, crd = build_entry(rec, structure=structure,
                                           origin=pnid)
        except StructureError as e:
            errors.record(pnid, errors.code_for_exception(e))
            continue
        except Exception:
            errors.record(pnid, ERROR_NAME_TO_CODE["UNKNOWN"])
            continue
        s = splits.setdefault(split, {"seq": [], "ang": [], "crd": [],
                                      "ids": []})
        s["seq"].append(seq)
        s["ang"].append(sincos)
        s["crd"].append(crd)
        s["ids"].append(pnid)
    return create_data_dict(splits, max_len=max_len)
