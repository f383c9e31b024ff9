"""Structure acquisition: ProteinNet IDs -> parsed, chain-selected atoms.

The port's own copy of protein_transformer_tpu/data/acquire.py.

Dependency-free replacement for the reference's ProDy acquisition path
(reference: scripts/proteinnet2pytorch.py:35-114 -- get_chain_from_trainid /
get_chain_from_testid / get_chain_from_proteinnetid -- plus the ASTRAL
helpers in protein/structure_utils.py:44-76). ProDy/PyMOL are not part of
this framework; PDB-format and mmCIF atom parsing, model (coordset) and
chain selection, altloc resolution and ASTRAL residue-range selection are
implemented directly on numpy.

Network fetching from RCSB is implemented but OFF by default: pass
``fetch=True`` (CLI: --fetch) to download into the cache directory. With
fetching disabled the cache directory acts as a local structure mirror, so
offline builds and tests use pre-placed files. Layout:
  <cache>/<pdbid>.pdb or <cache>/<pdbid>.cif     (train/valid entries)
  <targets>/<caspid>.pdb                         (test entries, CASP targets)
"""
from __future__ import annotations

import dataclasses
import functools
import os
import re
from typing import Optional

import numpy as np

from protein_transformer_tpu_torch.protein.constants import NUM_PREDICTED_COORDS
from protein_transformer_tpu_torch.protein import _ff14sb as ff
from protein_transformer_tpu_torch.protein.structure_exceptions import (
    CoordsetIndexError, MissingFileError, NoneStructureError, SequenceError)
from protein_transformer_tpu_torch.protein.vocab import (
    THREE_TO_ONE_LETTER_MAP, VOCAB)

GLOBAL_PAD_CHAR = np.nan

_RCSB_URL = "https://files.rcsb.org/download/{pdbid}.{ext}"


@dataclasses.dataclass
class Atoms:
    """Column-oriented atom table for one structure (all models)."""
    name: list[str]
    alt_loc: list[str]
    res_name: list[str]
    chain: list[str]
    res_num: np.ndarray           # (N,) int
    icode: list[str]
    model: np.ndarray             # (N,) int, 1-based
    hetero: np.ndarray            # (N,) bool
    occupancy: np.ndarray         # (N,) float
    xyz: np.ndarray               # (N, 3) float

    def __len__(self):
        return len(self.name)

    def take(self, idx: np.ndarray) -> "Atoms":
        sel = lambda lst: [lst[i] for i in idx]
        return Atoms(sel(self.name), sel(self.alt_loc), sel(self.res_name),
                     sel(self.chain), self.res_num[idx], sel(self.icode),
                     self.model[idx], self.hetero[idx], self.occupancy[idx],
                     self.xyz[idx])


# ------------------------------------------------------------- PDB format

def parse_pdb_text(text: str) -> Atoms:
    """Full fixed-column ATOM/HETATM parser with MODEL/altloc/icode support.

    (protein.pdb.parse_pdb_atoms stays as the minimal round-trip reader for
    files this framework wrote itself; this parser handles wild-type PDB
    entries the way ProDy's parsePDB did for the reference.)
    """
    cols: dict[str, list] = {k: [] for k in
                             ("name", "alt", "res", "chain", "num", "icode",
                              "model", "het", "occ", "xyz")}
    model = 1
    for line in text.splitlines():
        rec = line[:6]
        if rec.startswith("MODEL"):
            try:
                model = int(line[10:14])
            except ValueError:
                model += 1
            continue
        if rec not in ("ATOM  ", "HETATM"):
            continue
        try:
            xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
            num = int(line[22:26])
        except ValueError:
            continue
        cols["name"].append(line[12:16].strip())
        cols["alt"].append(line[16].strip())
        cols["res"].append(line[17:20].strip())
        cols["chain"].append(line[21].strip())
        cols["num"].append(num)
        cols["icode"].append(line[26].strip())
        cols["model"].append(model)
        cols["het"].append(rec == "HETATM")
        try:
            cols["occ"].append(float(line[54:60]))
        except (ValueError, IndexError):
            cols["occ"].append(1.0)
        cols["xyz"].append(xyz)
    return Atoms(cols["name"], cols["alt"], cols["res"], cols["chain"],
                 np.asarray(cols["num"], np.int64), cols["icode"],
                 np.asarray(cols["model"], np.int64),
                 np.asarray(cols["het"], bool),
                 np.asarray(cols["occ"], np.float64),
                 np.asarray(cols["xyz"], np.float64).reshape(-1, 3))


# ------------------------------------------------------------ mmCIF format

def _split_cif_row(s: str) -> list[str]:
    """Whitespace-split one CIF data row honoring CIF quoting: 'quoted
    value' / "quoted value" tokens may contain spaces (e.g. atom names like
    'C1'' or author strings); a naive str.split would shift every later
    column and silently drop the row at the field-count check."""
    if "'" not in s and '"' not in s:
        return s.split()
    out: list[str] = []
    i, n = 0, len(s)
    while i < n:
        if s[i].isspace():
            i += 1
            continue
        if s[i] in "'\"":
            q = s[i]
            j = i + 1
            # CIF closes a quote only at <quote><whitespace-or-EOL>
            while j < n and not (s[j] == q and (j + 1 == n
                                                or s[j + 1].isspace())):
                j += 1
            out.append(s[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and not s[j].isspace():
                j += 1
            out.append(s[i:j])
            i = j
    return out


def parse_mmcif_text(text: str) -> Atoms:
    """Parse the _atom_site loop of an mmCIF file (the fallback format the
    reference reached through pr.parseCIF, proteinnet2pytorch.py:61)."""
    lines = text.splitlines()
    fields: list[str] = []
    rows: list[list[str]] = []
    in_loop = False
    collecting = False
    for ln in lines:
        s = ln.strip()
        if s == "loop_":
            in_loop = True
            fields = []
            collecting = False
            continue
        if in_loop and s.startswith("_atom_site."):
            fields.append(s.split(".", 1)[1].split()[0])
            collecting = True
            continue
        if collecting:
            # `loop_` is consumed above, so any directive/comment/blank here
            # ends the _atom_site loop
            if s.startswith(("_", "#")) or not s:
                if rows:
                    break
                collecting = False
                continue
            row = _split_cif_row(s)
            if len(row) == len(fields):
                rows.append(row)
    if not rows:
        return parse_pdb_text("")  # empty Atoms

    ix = {f: i for i, f in enumerate(fields)}

    def col(name, default=""):
        if name not in ix:
            return [default] * len(rows)
        return [r[ix[name]] for r in rows]

    def clean(vals):
        return [("" if v in (".", "?") else v) for v in vals]

    names = clean(col("label_atom_id"))
    names = [n.strip("\"'") for n in names]
    res = clean(col("label_comp_id"))
    # auth_asym_id is the chain letter ProteinNet/PDB users see; fall back to
    # the label asym id when absent.
    chain = clean(col("auth_asym_id"))
    if all(c == "" for c in chain):
        chain = clean(col("label_asym_id"))
    num_src = col("auth_seq_id")
    if all(v in (".", "?", "") for v in num_src):
        num_src = col("label_seq_id")
    nums = [int(v) if v not in (".", "?", "") else 0 for v in num_src]
    icode = clean(col("pdbx_PDB_ins_code"))
    alt = clean(col("label_alt_id"))
    model = [int(v) if v not in (".", "?", "") else 1
             for v in col("pdbx_PDB_model_num", "1")]
    het = [g == "HETATM" for g in col("group_PDB", "ATOM")]
    occ = [float(v) if v not in (".", "?", "") else 1.0
           for v in col("occupancy", "1")]
    xyz = np.asarray([[float(v) for v in triple] for triple in
                      zip(col("Cartn_x", "0"), col("Cartn_y", "0"),
                          col("Cartn_z", "0"))], np.float64)
    return Atoms(names, alt, res, chain, np.asarray(nums, np.int64), icode,
                 np.asarray(model, np.int64), np.asarray(het, bool),
                 np.asarray(occ, np.float64), xyz)


@functools.lru_cache(maxsize=4)
def _parse_structure_cached(path: str, _mtime: float) -> Atoms:
    with open(path) as f:
        text = f.read()
    if path.endswith((".cif", ".mmcif")):
        return parse_mmcif_text(text)
    return parse_pdb_text(text)


def parse_structure_file(path: str) -> Atoms:
    """Parse a PDB/mmCIF file, memoized per (path, mtime): ProteinNet
    thinned sets contain many chains/domains per PDB entry, and re-parsing
    the identical file for each one multiplies build time by the
    chains-per-entry factor. Callers treat Atoms as read-only (every
    selection goes through Atoms.take, which copies)."""
    return _parse_structure_cached(path, os.path.getmtime(path))


# ------------------------------------------------------------- selection

def select_chain(atoms: Atoms, chain: Optional[str] = None,
                 model: int = 1, resnum_range: Optional[tuple] = None) -> Atoms:
    """Model (coordset) + chain + optional residue-range selection.

    Mirrors the reference's pr.parsePDB(pdbid, chain=chid) +
    chain.setACSIndex(model) (proteinnet2pytorch.py:57-81) and the ASTRAL
    resnum selection (structure_utils.py:68-75). Altlocs resolve to the
    highest-occupancy (first on tie) conformer; waters/het groups drop.
    """
    models = np.unique(atoms.model)
    if model not in models:
        # reference: coordset index errors surface as errors; but model
        # numbers in ProteinNet are 0-based coordset indices -- a file with
        # one MODEL record keeps it regardless
        if len(models) == 1:
            model = int(models[0])
        else:
            raise NoneStructureError(f"model {model} not present")
    keep = (atoms.model == model) & ~atoms.hetero
    # chain=None means no chain filtering; '' is a REAL (blank) chain id --
    # CASP target files often carry one, and skipping the filter there
    # would merge chains into chimeric records
    if chain is not None:
        keep &= np.asarray([c == chain for c in atoms.chain])
    if resnum_range is not None:
        lo, hi = resnum_range
        keep &= (atoms.res_num >= lo) & (atoms.res_num <= hi)
    sel = atoms.take(np.nonzero(keep)[0])

    # altloc resolution: keep the best conformer per (chain, resnum, icode,
    # atom) -- chain is part of the key so a chain=None (unfiltered)
    # selection cannot collapse same-numbered atoms across chains
    best: dict[tuple, int] = {}
    for i in range(len(sel)):
        key = (sel.chain[i], int(sel.res_num[i]), sel.icode[i], sel.name[i])
        if key not in best or sel.occupancy[i] > sel.occupancy[best[key]]:
            best[key] = i
    idx = np.asarray(sorted(best.values()), np.int64)
    return sel.take(idx) if len(idx) < len(sel) else sel


def atoms_to_record(atoms: Atoms):
    """Chain atoms -> (seq, coords (L, 14, 3) NaN-marked).

    Residues in (res_num, icode) order; non-standard residues are skipped
    (the reference routes them to the NONSTANDARD_AA error downstream when
    the sequence then mismatches)."""
    residues: dict[tuple, dict] = {}
    for i in range(len(atoms)):
        rn = atoms.res_name[i]
        if rn not in THREE_TO_ONE_LETTER_MAP:
            continue
        key = (int(atoms.res_num[i]), atoms.icode[i])
        rec = residues.setdefault(
            key, {"res": THREE_TO_ONE_LETTER_MAP[rn], "res3": rn,
                  "atoms": {}})
        if rec["res3"] != rn:
            # microheterogeneity: two residue TYPES share one number; keep
            # the first-seen type whole rather than merging atoms of both
            # into a chimera residue
            continue
        rec["atoms"].setdefault(atoms.name[i], atoms.xyz[i])
    keys = sorted(residues)
    seq = "".join(residues[k]["res"] for k in keys)
    coords = np.full((len(keys), NUM_PREDICTED_COORDS, 3), GLOBAL_PAD_CHAR)
    for li, key in enumerate(keys):
        rec = residues[key]
        slot_names = ff.ATOM_NAMES_14[VOCAB[rec["res"]]]
        for slot, nm in enumerate(slot_names):
            if nm and nm in rec["atoms"]:
                coords[li, slot] = rec["atoms"][nm]
    if not seq:
        raise SequenceError("no standard residues in selection")
    return seq, coords


# ---------------------------------------------------------------- ASTRAL

def parse_astral_summary_file(path: str) -> dict[str, tuple[str, str]]:
    """ASTRAL dir.cla summary -> {astral_id: (pdbid, chain_spec)}.

    Parity with structure_utils.parse_astral_summary_file:44-58 (skip '#'
    comments, skip '-' entries, first occurrence wins)."""
    d: dict[str, tuple[str, str]] = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            items = line.split()
            if len(items) < 6 or items[3] == "-":
                continue
            if items[3] not in d:
                d[items[3]] = (items[4], items[5])
    return d


def parse_chain_spec(spec: str) -> tuple[str, Optional[tuple[int, int]]]:
    """'A:' -> ('A', None); 'A:12-89' -> ('A', (12, 89)); handles negative
    start residues like 'B:-5-120' (structure_utils.py:68-75) and SCOPe
    boundaries carrying insertion codes like 'A:1B-107' (the icode letter
    is dropped: range matching is by residue NUMBER, which at worst widens
    the selection by the sub-numbered residues at the boundaries)."""
    if "," in spec:
        raise ValueError(f"multi-range ASTRAL spec unsupported: {spec}")
    chain, _, resnums = spec.partition(":")
    if not resnums:
        return chain, None
    m = re.fullmatch(r"(-?\d+)[A-Za-z]?-(-?\d+)[A-Za-z]?", resnums)
    if not m:
        raise ValueError(f"bad residue range {resnums!r}")
    return chain, (int(m.group(1)), int(m.group(2)))


# ---------------------------------------------------------------- fetch

def fetch_structure(pdbid: str, cache_dir: str, fetch: bool = False) -> str:
    """Resolve a PDB ID to a local file, optionally downloading from RCSB.

    Search order: <cache>/<id>.pdb, <cache>/<id>.cif (case-insensitive id);
    then, when fetch=True, download .pdb falling back to .cif (the
    reference's parsePDB -> parseCIF fallback, proteinnet2pytorch.py:57-61).
    """
    pdbid = pdbid.lower()
    for ext in ("pdb", "cif"):
        for cand in (pdbid, pdbid.upper()):
            p = os.path.join(cache_dir, f"{cand}.{ext}")
            if os.path.exists(p):
                return p
    if not fetch:
        raise MissingFileError(
            f"{pdbid}: not in cache {cache_dir!r} and fetching disabled "
            "(pass --fetch to download from RCSB)")
    import urllib.request
    os.makedirs(cache_dir, exist_ok=True)
    last_err: Exception | None = None
    for ext in ("pdb", "cif"):
        url = _RCSB_URL.format(pdbid=pdbid.upper(), ext=ext)
        out = os.path.join(cache_dir, f"{pdbid}.{ext}")
        try:
            with urllib.request.urlopen(url, timeout=60) as r:
                data = r.read()
            with open(out, "wb") as f:
                f.write(data)
            return out
        except Exception as e:  # noqa: BLE001 - error taxonomy downstream
            last_err = e
    raise NoneStructureError(f"{pdbid}: download failed ({last_err})")


# ------------------------------------------------------------ ID routing

_TEST_MARKERS = ("TBM#", "FM#", "TBM-hard", "FM-hard")


def parse_proteinnet_id(pnid: str) -> dict:
    """Classify a ProteinNet ID (proteinnet2pytorch.py:35-114).

    Returns {'kind': 'test', 'caspid': ...} for CASP targets,
    {'kind': 'train', 'pdbid': ..., 'model': int, 'chain': ...} for
    PDB-backed entries, or {'kind': 'astral', 'pdbid': ..., 'astral': ...}.
    """
    if any(m in pnid for m in _TEST_MARKERS):
        _category, _, caspid = pnid.partition("#")
        return {"kind": "test", "caspid": caspid}
    parts = pnid.split("_")
    if len(parts) == 3:
        pdbid, model, chain = parts
        if "#" in pdbid:  # e.g. "70#1A9U" in thinned training sets
            pdbid = pdbid.split("#")[1]
        return {"kind": "train", "pdbid": pdbid, "model": int(model),
                "chain": chain}
    if len(parts) == 2:
        pdbid, astral = parts
        return {"kind": "astral", "pdbid": pdbid,
                "astral": astral.replace("-", "_")}
    raise ValueError(f"unrecognized ProteinNet id {pnid!r}")


def get_chain_from_proteinnetid(pnid: str, cache_dir: str,
                                targets_dir: Optional[str] = None,
                                astral_map: Optional[dict] = None,
                                fetch: bool = False):
    """ProteinNet ID -> (seq, coords (L, 14, 3)).

    The full acquisition route of the reference's work() entry
    (proteinnet2pytorch.py:35-114): test targets from a local CASP targets
    directory, train/valid from the PDB (cache or RCSB), ASTRAL domains via
    the summary-file mapping with residue-range selection.
    """
    info = parse_proteinnet_id(pnid)
    if info["kind"] == "test":
        if not targets_dir:
            raise MissingFileError(f"{pnid}: no targets_dir configured")
        path = os.path.join(targets_dir, f"{info['caspid']}.pdb")
        if not os.path.exists(path):
            raise MissingFileError(path)
        atoms = parse_structure_file(path)
        # CASP target files are expected to hold one chain; when more are
        # present the reference takes the FIRST chain of the hierarchical
        # view (next(iter(pdb_hv)), proteinnet2pytorch.py:95-100) -- merging
        # chains would garble residue numbering across chains.
        first_chain = atoms.chain[0] if len(atoms.chain) else None
        sel = select_chain(atoms, chain=first_chain,
                           model=int(atoms.model.min()))
        return atoms_to_record(sel)

    if info["kind"] == "astral":
        if not astral_map:
            raise MissingFileError(f"{pnid}: no ASTRAL mapping loaded")
        if info["astral"] not in astral_map:
            raise KeyError(info["astral"])
        pdbid, spec = astral_map[info["astral"]]
        chain, rng = parse_chain_spec(spec)
        path = fetch_structure(pdbid, cache_dir, fetch)
        atoms = parse_structure_file(path)
        sel = select_chain(atoms, chain=chain, model=int(atoms.model.min()),
                           resnum_range=rng)
        return atoms_to_record(sel)

    path = fetch_structure(info["pdbid"], cache_dir, fetch)
    atoms = parse_structure_file(path)
    # ProteinNet model ids are 0-based coordset indices; MODEL records are
    # 1-based. Single-model files ignore the index (setACSIndex only ran
    # when numCoordsets() > 1, proteinnet2pytorch.py:76-79). An out-of-range
    # index is an error (COORDSET_INDEX), never a silent clamp: training on
    # a different conformer would corrupt the record.
    models = np.unique(atoms.model)
    if len(models) == 1:
        model = int(models[0])
    elif info["model"] >= len(models):
        raise CoordsetIndexError(
            f"{pnid}: model index {info['model']} >= {len(models)} coordsets")
    else:
        model = int(models[info["model"]])
    sel = select_chain(atoms, chain=info["chain"], model=model)
    return atoms_to_record(sel)
