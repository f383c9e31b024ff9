"""The port's dataset tools against the JAX package's, on the same files.

The port keeps its own copies of ``protein/structure_exceptions.py``,
``protein/measure.py`` and ``data/{align,convert,acquire,proteinnet}.py``,
and its own ``scripts/`` in place of the ``ptt_scripts`` that compute
through the JAX package. Each is held to the JAX module on the fixtures
that tests/test_proteinnet.py, test_align.py, test_acquire.py,
test_measure.py and test_wildtype.py build in place, with structures built
by the port's geometry: arrays equal bit for bit (the same numpy), dicts,
ids and error reports equal, the same exception classes raised (by name).
The rebuild of ``dataset_item_to_pdb`` goes through the two packages' NeRF
builders, which agree to fp32 rounding: its coordinates within the PDB
files' 1e-3 A. Nothing is fetched: ``fetch`` stays False.

Cost: ~10 s in one worker (the JAX rebuild's compile, two spawned parse
workers).
"""
import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

from protein_transformer_tpu.data import acquire as jaq
from protein_transformer_tpu.data import align as jal
from protein_transformer_tpu.data import convert as jconv
from protein_transformer_tpu.data import proteinnet as jpn
from protein_transformer_tpu.protein import measure as jmeasure
from protein_transformer_tpu.protein import structure_exceptions as jexc
from protein_transformer_tpu_torch.data import acquire as taq
from protein_transformer_tpu_torch.data import align as tal
from protein_transformer_tpu_torch.data import convert as tconv
from protein_transformer_tpu_torch.data import proteinnet as tpn
from protein_transformer_tpu_torch.data.synthetic import random_angles
from protein_transformer_tpu_torch.protein import measure as tmeasure
from protein_transformer_tpu_torch.protein import (
    structure_exceptions as texc)
from protein_transformer_tpu_torch.protein.geometry import build_coords
from protein_transformer_tpu_torch.protein.pdb import PdbWriter
from protein_transformer_tpu_torch.protein.vocab import STD_AAS, VOCAB
from protein_transformer_tpu_torch.scripts import (
    dataset_item_to_pdb, export_embeddings_to_tsv, proteinnet_to_dataset)
from protein_transformer_tpu_torch.training import cli as tcli

from test_proteinnet import RAW_RECORD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WILD = os.path.join(ROOT, "tests", "data")


def jax_script(name):
    return importlib.import_module(f"ptt_scripts.{name}")


def port_protein(rng, length, seq=None):
    """(seq, (L, 14, 3) float32 coordinates) built by the port's geometry
    from random physical angles, and the angles."""
    seq = seq or "".join(rng.choice(list(STD_AAS), size=length))
    ang = random_angles(rng, len(seq))
    ids = torch.tensor([VOCAB[c] for c in seq])
    with torch.no_grad():
        crd = build_coords(torch.from_numpy(ang), ids).numpy()
    return seq, crd, ang


def pdb_lines(crd, seq, chain):
    return [ln for ln in PdbWriter(crd, seq, chain=chain).lines()
            if ln.startswith("ATOM")]


@pytest.fixture(scope="module")
def proteins():
    rng = np.random.default_rng(7)
    return [port_protein(rng, n) for n in (10, 8, 24)]


@pytest.fixture(scope="module")
def two_chain_text(proteins):
    """tests/test_acquire.py's fixture: chains A and B in model 1, chain A
    moved by 5 A in model 2."""
    (seq_a, crd_a, _), (seq_b, crd_b, _) = proteins[:2]
    body = pdb_lines(crd_a, seq_a, "A") + ["TER"] + pdb_lines(crd_b, seq_b,
                                                              "B")
    text = (["MODEL        1"] + body + ["ENDMDL", "MODEL        2"]
            + pdb_lines(crd_a + 5.0, seq_a, "A") + ["ENDMDL", "END"])
    return "\n".join(text) + "\n"


def same(ours, theirs, path="value"):
    """Equal, recursively: arrays bit for bit (NaN where NaN), dataclasses
    field by field, dicts key for key, the same exception class by name."""
    if isinstance(theirs, BaseException):
        assert type(ours).__name__ == type(theirs).__name__, path
        assert str(ours) == str(theirs), path
    elif dataclasses.is_dataclass(theirs):
        assert type(ours).__name__ == type(theirs).__name__, path
        for f in dataclasses.fields(theirs):
            same(getattr(ours, f.name), getattr(theirs, f.name),
                 f"{path}.{f.name}")
    elif isinstance(theirs, dict):
        assert list(ours) == list(theirs), path
        for k in theirs:
            same(ours[k], theirs[k], f"{path}[{k!r}]")
    elif isinstance(theirs, (list, tuple)):
        assert type(ours) is type(theirs) and len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            same(a, b, f"{path}[{i}]")
    elif isinstance(theirs, np.ndarray):
        assert isinstance(ours, np.ndarray), path
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, path
        np.testing.assert_array_equal(ours, theirs, err_msg=path)
    else:
        assert ours == theirs or (ours != ours and theirs != theirs), path


def outcome(fn, *args, **kw):
    """fn's result, or the exception it raised."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # the exception is the outcome compared
        return e


def both(name, ours_mod, theirs_mod, *args, **kw):
    """The port's outcome of ``name(*args, **kw)``, held equal to JAX's."""
    ours = outcome(getattr(ours_mod, name), *args, **kw)
    same(ours, outcome(getattr(theirs_mod, name), *args, **kw), name)
    return ours


# ----------------------------------------------- exceptions, measurement

@pytest.mark.parametrize("name", sorted(
    n for n, v in vars(jexc).items()
    if isinstance(v, type) and issubclass(v, Exception)))
def test_exception_classes_match(name):
    ours, theirs = getattr(texc, name), getattr(jexc, name)
    assert [c.__name__ for c in ours.__mro__] == [
        c.__name__ for c in theirs.__mro__]


def test_measurement_matches_jax(proteins, tmp_path):
    rng = np.random.default_rng(3)
    seq, crd, _ = port_protein(rng, 40, seq="ACDEFGHIKLMNPQRSTVWY" * 2)
    ids = np.array([VOCAB[c] for c in seq], np.int32)
    same(tmeasure.N_CHI, jmeasure.N_CHI)
    for name, args in (
            ("coords_to_angles", (crd, ids)),
            ("measure_backbone_angles", (crd,)),
            ("measure_sidechain_dihedrals", (crd, ids)),
            ("dihedral", tuple(crd[:, i] for i in range(4))),
            ("bond_angle", tuple(crd[:, i] for i in range(3))),
            ("angles_to_sincos", (tmeasure.coords_to_angles(crd, ids),))):
        both(name, tmeasure, jmeasure, *args)
    path = str(tmp_path / "m.pdb")
    PdbWriter(crd, seq).save_pdb(path)
    both("pdb_to_record", tmeasure, jmeasure, path)


# ------------------------------------------------------------- alignment

ALIGN_CASES = [
    ("AAAAAAAAGAPAAAAAAA", "AAAAAAAAAAAAAAA", "++++++++---+++++++"),
    ("STARTAAAAAAAAAGAPAAAAAA", "AAAAAAAAAAAAAAA",
     "-----+++++++++---++++++"),
    ("STARTAAAAAAAGAAAAPAAAAAAAAAEND", "AAAAAAAAAAAAAAAA",
     "-----+++++++------+++++++++---"),
    ("MKTWGGGHRLVNPPPIKQ", "KTWRLVNIKQ", "+" * 18),
    ("AAAA", "W", "++++"),
    ("MKV", "MKVL", "+++"),
    ("MKV", "", "---"),
]


@pytest.mark.parametrize("primary,observed,mask", ALIGN_CASES)
def test_alignment_matches_jax(primary, observed, mask):
    both("compute_alignment_mask", tal, jal, primary, observed)
    both("can_be_directly_merged", tal, jal, primary, observed, mask)
    both("str_mask_to_binary", tal, jal, mask)
    both("binary_mask_to_str", tal, jal, jal.str_mask_to_binary(mask))


# ----------------------------------------------------------- acquisition

def test_parsers_match_jax_on_built_and_wild_type_files(two_chain_text,
                                                        proteins):
    (seq_a, crd_a, _), _, _ = proteins
    cif = "\n".join(["data_t", "#", "loop_"] + [
        f"_atom_site.{f}" for f in (
            "group_PDB", "id", "label_atom_id", "label_alt_id",
            "label_comp_id", "auth_asym_id", "auth_seq_id",
            "pdbx_PDB_ins_code", "Cartn_x", "Cartn_y", "Cartn_z",
            "occupancy", "pdbx_PDB_model_num")] + [
        f"ATOM {i} {ln[12:16].strip()} . {ln[17:20]} A {int(ln[22:26])} ? "
        f"{ln[30:38]} {ln[38:46]} {ln[46:54]} 1.00 1"
        for i, ln in enumerate(pdb_lines(crd_a, seq_a, "A"))] + ["#"]) + "\n"
    for name, text in (("parse_pdb_text", two_chain_text),
                       ("parse_mmcif_text", cif)):
        both(name, taq, jaq, text)
    for wild in ("9xqa.pdb", "9xqb.cif"):
        path = os.path.join(WILD, wild)
        both("parse_structure_file", taq, jaq, path)
    for row in ("ATOM 1 N 'VAL A' 2", 'ATOM "O5\'" X', "plain row only"):
        both("_split_cif_row", taq, jaq, row)


@pytest.mark.parametrize("source,chain,model,resnums", [
    ("built", "B", 1, None), ("built", "A", 2, None), ("built", "A", 3, None),
    ("built", None, 1, None), ("built", "A", 1, (3, 8)),
    ("9xqa.pdb", "A", 1, None), ("9xqa.pdb", "A", 2, None),
    ("9xqa.pdb", "B", 1, None), ("9xqa.pdb", "Z", 1, None),
    ("9xqb.cif", "AA", 1, None), ("9xqb.cif", "BB", 2, None)])
def test_chain_selection_and_records_match_jax(two_chain_text, source, chain,
                                               model, resnums):
    if source == "built":
        ours, theirs = (taq.parse_pdb_text(two_chain_text),
                        jaq.parse_pdb_text(two_chain_text))
    else:
        path = os.path.join(WILD, source)
        ours, theirs = (taq.parse_structure_file(path),
                        jaq.parse_structure_file(path))
    sel_t = outcome(taq.select_chain, ours, chain=chain, model=model,
                    resnum_range=resnums)
    sel_j = outcome(jaq.select_chain, theirs, chain=chain, model=model,
                    resnum_range=resnums)
    same(sel_t, sel_j)
    if not isinstance(sel_j, Exception):
        same(outcome(taq.atoms_to_record, sel_t),
             outcome(jaq.atoms_to_record, sel_j))


@pytest.mark.parametrize("pnid", [
    "1A9U_2_A", "70#1A9U_2_A", "1ABC_d1abca-", "TBM#T0860", "FM-hard#T0900",
    "not-an-id-at-all_x_y_z"])
def test_id_routing_matches_jax(pnid):
    both("parse_proteinnet_id", taq, jaq, pnid)


@pytest.mark.parametrize("spec", ["A:", "A:12-89", "B:-5-120", "A:1B-107",
                                  "B:2-77A", "A:12-89,B:1-5", "A:x-y"])
def test_chain_specs_match_jax(spec):
    both("parse_chain_spec", taq, jaq, spec)


def test_acquisition_routes_match_jax(tmp_path, two_chain_text, proteins):
    """The local cache (pdb and cif, either case of the id), fetch off,
    the train, test and ASTRAL routes, and their failures."""
    (seq_a, crd_a, _), _, _ = proteins
    cache, targets = tmp_path / "cache", tmp_path / "targets"
    cache.mkdir()
    targets.mkdir()
    (cache / "1fak.pdb").write_text(two_chain_text)
    (cache / "2FOO.pdb").write_text("\n".join(pdb_lines(crd_a, seq_a, "A")))
    (targets / "T0999.pdb").write_text(
        "\n".join(pdb_lines(crd_a, seq_a, "A")) + "\n")
    astral = tmp_path / "dir.cla.txt"
    astral.write_text("# comment line\n"
                      "d1a9ua_ 1a9u A: d2fooa_ 2foo A:3-8 rest\n"
                      "d1xyza_ 1xyz - - skipme -\n")
    both("parse_astral_summary_file", taq, jaq, str(astral))
    amap = taq.parse_astral_summary_file(str(astral))
    found = [both("fetch_structure", taq, jaq, pdbid, str(cache),
                  fetch=False) for pdbid in ("1fak", "1FAK", "2foo", "9xyz")]
    assert found[0] == found[1] == str(cache / "1fak.pdb")
    assert type(found[3]).__name__ == "MissingFileError"
    got = {pnid: both("get_chain_from_proteinnetid", taq, jaq, pnid,
                      str(cache), targets_dir=str(targets), astral_map=amap,
                      fetch=False)
           for pnid in ("1FAK_0_B", "1FAK_1_A", "1FAK_5_A", "2FOO_d2fooa-",
                        "2FOO_d9zzza-", "TBM#T0999", "TBM#T0001",
                        "9ZZZ_1_A")}
    assert got["1FAK_0_B"][0] == proteins[1][0]
    assert got["2FOO_d2fooa-"][0] == seq_a[2:8]
    assert got["TBM#T0999"][0] == seq_a
    assert [type(got[k]).__name__ for k in (
        "1FAK_5_A", "2FOO_d9zzza-", "TBM#T0001", "9ZZZ_1_A")] == [
        "CoordsetIndexError", "KeyError", "MissingFileError",
        "MissingFileError"]
    both("get_chain_from_proteinnetid", taq, jaq, "TBM#T0999", str(cache))
    both("get_chain_from_proteinnetid", taq, jaq, "2FOO_d2fooa-",
         str(cache))


# ------------------------------------------------------------- ProteinNet

@pytest.mark.parametrize("tertiary", [False, True])
def test_record_parsing_matches_jax(tmp_path, tertiary):
    path = tmp_path / "training_30"
    rec = RAW_RECORD.replace("[MASK]\n++++--", "[TERTIARY]\n" + "\n".join(
        " ".join(str(float(i + j)) for i in range(18)) for j in range(3))
        + "\n[MASK]\n++++--")
    path.write_text(rec + "[ID]\nTAIL\n[PRIMARY]\nAC\n")
    same(list(tpn.parse_proteinnet_records(str(path), tertiary)),
         list(jpn.parse_proteinnet_records(str(path), tertiary)))


@pytest.mark.parametrize("n_workers", [0, 2])
def test_raw_directory_parsing_matches_jax(tmp_path, n_workers):
    """Serially and in two spawned workers: the records and the .ids
    listings of the JAX parser."""
    raw = tmp_path / "raw"
    raw.mkdir()
    (raw / "training_30").write_text(RAW_RECORD)
    (raw / "validation").write_text(RAW_RECORD.replace("1ABC", "30#1ABD")
                                    .replace("2XYZ", "30#2XYW"))
    (raw / "old.ids").write_text("skipped\n")
    got = tpn.parse_raw_proteinnet(str(raw), out_dir=str(tmp_path / "t"),
                                   n_workers=n_workers)
    want = jpn.parse_raw_proteinnet(str(raw), out_dir=str(tmp_path / "j"),
                                    n_workers=n_workers)
    same(got, want)
    assert len(got) == 4
    for name in ("training_30.ids", "validation.ids"):
        assert (tmp_path / "t" / name).read_text() == (
            tmp_path / "j" / name).read_text()


@pytest.mark.parametrize("primary,mask,observed", [
    ("MKVLAA", [1, 1, 0, 1, 1, 0], "MKLA"), ("AAGVKAA", [1] * 7, "GVK"),
    ("AGAGA", [1] * 5, "GA"), ("AAAA", [1] * 4, "W"),
    ("MKTWGGGHRLVNPPPIKQ", [1] * 18, "KTWRLVNIKQ"),
    ("MKV", [1, 1], "MK"), ("MKV", None, "MKV")])
def test_mask_alignment_matches_jax(primary, mask, observed):
    n = len(observed)
    ang = np.arange(n * 12, dtype=np.float32).reshape(n, 12)
    crd = np.arange(n * 14 * 3, dtype=np.float32).reshape(n * 14, 3)
    got = both("align_observed_to_mask", tpn, jpn, primary, mask, observed,
               ang, crd)
    if not isinstance(got, Exception):
        assert np.isfinite(got[0]).sum() == ang.size


def test_error_taxonomy_matches_jax(tmp_path):
    assert tpn.ERROR_CODES == jpn.ERROR_CODES
    assert tpn.ERROR_NAME_TO_CODE == jpn.ERROR_NAME_TO_CODE
    reports = {}
    for pkg, pn, exc in (("t", tpn, texc), ("j", jpn, jexc)):
        errors = pn.ProteinErrors()
        for i, name in enumerate(sorted(
                n for n, v in vars(exc).items()
                if isinstance(v, type) and issubclass(v, Exception))):
            errors.record(f"id{i}", errors.code_for_exception(
                getattr(exc, name)()))
        errors.record("x", errors.code_for_exception(KeyError()))
        other = pn.ProteinErrors()
        other.record("y", pn.ERROR_NAME_TO_CODE["PARSING_ERROR"])
        errors.merge(other)
        errors.write_reports(str(tmp_path / pkg))
        reports[pkg] = (errors.counts, errors.total(), errors.summarize(),
                        {f: (tmp_path / pkg / f).read_text()
                         for f in sorted(os.listdir(tmp_path / pkg))})
    same(reports["t"], reports["j"])


def test_dataset_assembly_matches_jax(tmp_path, two_chain_text, proteins):
    """build_dataset through the cache, the CASP targets and per-id files,
    with its failures; angle means with a column no protein carries."""
    (seq_a, crd_a, _), (seq_b, _, _), (seq_c, crd_c, _) = proteins
    cache, targets = tmp_path / "cache", tmp_path / "targets"
    cache.mkdir()
    targets.mkdir()
    (cache / "1fak.pdb").write_text(two_chain_text)
    PdbWriter(crd_c, seq_c).save_pdb(str(cache / "p3.pdb"))
    (targets / "T0999.pdb").write_text(
        "\n".join(pdb_lines(crd_a, seq_a, "A")) + "\n")
    (cache / "short.pdb").write_text("\n".join(
        pdb_lines(crd_a[:1], seq_a[:1], "A")) + "\n")
    records = {
        "1FAK_0_B": {"primary": seq_b, "mask": [1] * len(seq_b)},
        "1FAK_1_A": {"primary": "MM" + seq_a, "mask": [0, 0]
                     + [1] * len(seq_a)},
        "p3": {"primary": seq_c, "mask": [1] * len(seq_c)},
        "TBM#T0999": {"primary": seq_a, "mask": [1] * len(seq_a)},
        "short": {"primary": seq_a[:1], "mask": [1]},
        "9ZZZ_1_A": {"primary": "AAAA", "mask": [1] * 4},
        "1FAK_7_A": {"primary": seq_a, "mask": [1] * len(seq_a)},
        "1FAK_0_Q": {"primary": seq_a, "mask": [1] * len(seq_a)},
        "bad-id": {"primary": "AA", "mask": [1, 1]},
        "1FAK_0_A": {"primary": "WWWW", "mask": [1] * 4},
    }

    def split_of(pnid):
        return "test" if "#" in pnid else ("valid-70" if pnid == "p3"
                                           else "train")

    got, want = {}, {}
    for out, pn in ((got, tpn), (want, jpn)):
        errors = pn.ProteinErrors()
        out["data"] = pn.build_dataset(records, str(cache), split_of,
                                       errors=errors,
                                       targets_dir=str(targets))
        out["errors"] = errors.counts
    same(got, want)
    assert got["data"]["train"]["ids"] and got["data"]["test"]["ids"]
    a = np.full((3, 24), 0.25, np.float32)
    a[:, 7] = np.nan
    both("compute_angle_means", tpn, jpn, [a, a[:2] + 0.5])


def test_conversion_matches_jax(tmp_path, proteins):
    data = {"train": {"seq": [s for s, _, _ in proteins],
                      "ang": [np.stack([np.cos(a), np.sin(a)], -1).reshape(
                          len(a), 24) for _, _, a in proteins],
                      "crd": [c.reshape(-1, 3) for _, c, _ in proteins],
                      "ids": ["a", "b", "c"]},
            "settings": {"max_len": 500, "angle_means": np.zeros(24),
                         "bin_data": {"edges": np.arange(3)}},
            "date": {"2020-01-01"}}
    for pkg, conv in (("t", tconv), ("j", jconv)):
        conv.convert(data, str(tmp_path / pkg))
        conv.export_pt(data, str(tmp_path / f"{pkg}.pt"))
    for name in ("manifest.json",):
        assert (tmp_path / "t" / name).read_text() == (
            tmp_path / "j" / name).read_text()
    ours, theirs = (np.load(tmp_path / "t" / "train.npz"),
                    np.load(tmp_path / "j" / "train.npz"))
    same(dict(ours), dict(theirs))
    assert sorted(ours) == ["ang", "crd", "ids", "offsets", "seqs"]
    same(torch.load(tmp_path / "t.pt", weights_only=False)["train"],
         torch.load(tmp_path / "j.pt", weights_only=False)["train"])
    # the port's CLI entry converts back to a reference .pt
    tconv.main([str(tmp_path / "t"), str(tmp_path / "back.pt")])
    back = torch.load(tmp_path / "back.pt", weights_only=False)
    assert back["train"]["seq"] == data["train"]["seq"]


# ---------------------------------------------------------------- scripts

def raw_dir(tmp_path, two_chain_text, proteins):
    """tests/test_acquire.py's script fixture: a training, a validation and
    a testing file, the structure cache and the CASP targets."""
    (seq_a, crd_a, _), (seq_b, _, _), _ = proteins
    raw = tmp_path / "raw"
    raw.mkdir()
    (raw / "training_30").write_text(
        f"[ID]\n1FAK_0_B\n[PRIMARY]\n{seq_b}\n[MASK]\n{'+' * len(seq_b)}\n\n")
    (raw / "training_90").write_text(
        f"[ID]\n1FAK_1_A\n[PRIMARY]\n{seq_a}\n[MASK]\n{'+' * len(seq_a)}\n\n")
    (raw / "validation").write_text(
        f"[ID]\n30#1FAK_0_A\n[PRIMARY]\n{seq_a}\n[MASK]\n"
        f"{'+' * len(seq_a)}\n\n[ID]\nX#1FAK_0_B\n[PRIMARY]\n{seq_b}\n"
        f"[MASK]\n{'+' * len(seq_b)}\n\n")
    (raw / "testing").write_text(
        f"[ID]\nTBM#T0999\n[PRIMARY]\n{seq_a}\n[MASK]\n{'+' * len(seq_a)}\n\n")
    cache, targets = tmp_path / "structs", tmp_path / "targets"
    cache.mkdir()
    targets.mkdir()
    (cache / "1fak.pdb").write_text(two_chain_text)
    (targets / "T0999.pdb").write_text(
        "\n".join(pdb_lines(crd_a, seq_a, "A")) + "\n")
    return [str(raw), str(cache)], ["--targets", str(targets)]


@pytest.mark.parametrize("out", ["data.pt", "native"])
def test_dataset_builder_matches_the_jax_script(tmp_path, two_chain_text,
                                                proteins, out, capsys):
    args, opts = raw_dir(tmp_path, two_chain_text, proteins)
    errors = {p: str(tmp_path / f"errors_{p}") for p in ("t", "j")}
    proteinnet_to_dataset.main(args + [str(tmp_path / f"t_{out}")] + opts
                               + ["--errors_dir", errors["t"]])
    ours_out = capsys.readouterr().out
    jax_script("proteinnet_to_dataset").main(
        args + [str(tmp_path / f"j_{out}")] + opts
        + ["--errors_dir", errors["j"]])
    assert ours_out.replace(f"t_{out}", f"j_{out}") == \
        capsys.readouterr().out
    from protein_transformer_tpu_torch.data.dataset import load_dataset
    ours, theirs = (load_dataset(str(tmp_path / f"{p}_{out}"))
                    for p in ("t", "j"))
    same(ours, theirs)
    assert ours["train"]["ids"] == ["1FAK_0_B"]
    assert ours["valid-30"]["ids"] == ["30#1FAK_0_A"]
    assert ours["valid-70"]["ids"] == ["X#1FAK_0_B"]
    assert ours["test"]["ids"] == ["TBM#T0999"]
    assert os.listdir(errors["t"]) == os.listdir(errors["j"])


def parsed(path):
    from protein_transformer_tpu_torch.protein.measure import pdb_to_record
    return pdb_to_record(path)


def test_item_to_pdb_matches_the_jax_script(tmp_path, two_chain_text,
                                            proteins, capsys):
    """The true structure's file byte for byte; the rebuild from the stored
    angles through the port's geometry on the CPU within 1e-3 A of the JAX
    script's (written with three decimals)."""
    args, opts = raw_dir(tmp_path, two_chain_text, proteins)
    data = str(tmp_path / "d.pt")
    proteinnet_to_dataset.main(args + [data] + opts)
    item = ["--split", "valid-30", "--idx", "0", "--rebuild"]
    ours = dataset_item_to_pdb.main([data, *item, "--device", "cpu", "--out",
                                     str(tmp_path / "t_true.pdb")])
    jax_script("dataset_item_to_pdb").main(
        [data, *item, "--out", str(tmp_path / "j_true.pdb")])
    assert ours == [str(tmp_path / f"t_{k}.pdb") for k in ("true",
                                                          "rebuilt")]
    capsys.readouterr()
    assert (tmp_path / "t_true.pdb").read_text() == (
        tmp_path / "j_true.pdb").read_text()
    (seq, got), (seq_j, want) = (parsed(str(tmp_path / f"{p}_rebuilt.pdb"))
                                 for p in ("t", "j"))
    assert seq == seq_j
    real = np.isfinite(want[..., 0])
    assert (np.isfinite(got[..., 0]) == real).all()
    assert np.abs(got[real] - want[real]).max() <= 1.001e-3
    # the rebuild itself, against a float64 build of the same angles
    split = torch.load(data, weights_only=False)["valid-30"]
    sincos = np.nan_to_num(split["ang"][0])
    rebuilt = dataset_item_to_pdb.rebuild_coords(sincos, seq,
                                                 torch.device("cpu"))
    ang = np.arctan2(sincos[:, 1::2], sincos[:, 0::2])
    exact = build_coords(torch.from_numpy(ang).double(), torch.tensor(
        [VOCAB[c] for c in seq])).numpy()
    assert np.abs(rebuilt - exact).max() <= 1e-3
    if not torch.cuda.is_available():  # the default is the GPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dataset_item_to_pdb.main([data, *item, "--out",
                                      str(tmp_path / "x_true.pdb")])


def test_embedding_export_matches_the_jax_script(tmp_path, monkeypatch):
    """A port run's table is the one JAX's find_embedding picks in the
    run's flax tree, and both scripts write the same two files."""
    from protein_transformer_tpu_torch.data.synthetic import make_dataset
    from protein_transformer_tpu_torch.models.flax_import import (
        flax_names, to_flax_layout)
    from protein_transformer_tpu_torch.predict import load_run
    path = tmp_path / "d.pt"
    torch.save(make_dataset(n_train=6, n_eval=1, min_len=10, max_len=20,
                            seed=1), path)
    tcli.main(["--data", str(path), "--name", "e", "--out_dir",
               str(tmp_path), "-m", "conv-enc|3|1", "-dm", "8", "-dih",
               "16", "-nh", "2", "-nl", "1", "-e", "1", "-b", "4", "-l",
               "mse", "--train_only", "--log_structure_step", "0",
               "--cluster", "True", "--device", "cpu"])
    run_dir = str(tmp_path / "e")
    export_embeddings_to_tsv.main([run_dir, "--out", str(tmp_path / "t"),
                                   "--device", "cpu"])
    _, model = load_run(run_dir, device="cpu")
    tree = {}
    for name, fpath in flax_names(model).items():
        node = tree
        for seg in fpath.split("/")[:-1]:
            node = node.setdefault(seg, {})
        node[fpath.split("/")[-1]] = to_flax_layout(
            model.state_dict()[name].numpy(), fpath)
    script = jax_script("export_embeddings_to_tsv")
    np.testing.assert_array_equal(
        export_embeddings_to_tsv.find_embedding(model),
        script.find_embedding({"params": tree}))
    import protein_transformer_tpu.predict as jpredict
    monkeypatch.setattr(jpredict, "load_run",
                        lambda *a: (None, None, {"params": tree}))
    script.main([run_dir, "--out", str(tmp_path / "j")])
    for name in ("vectors.tsv", "labels.tsv"):
        assert (tmp_path / "t" / name).read_text() == (
            tmp_path / "j" / name).read_text()
    assert len((tmp_path / "t" / "labels.tsv").read_text().split()) == 22
