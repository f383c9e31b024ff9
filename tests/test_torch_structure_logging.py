"""The port's structure logging against the JAX package's.

* ``protein/gltf.py`` (the port's own copy): ``structure_bonds``,
  ``coords_to_glb`` and ``scene_to_glb`` byte for byte against the
  original's, and the ``.glb`` container parsed;
* ``PdbWriter.lines`` line for line against the JAX package's writer,
  with missing (NaN), all-zero and every kind of residue, on each chain
  label;
* ``kabsch_align`` against the original's and on a known rigid motion;
* ``StructureLogger``: the files of one structure equal to the JAX logger's
  (PDB text and ``.glb`` bytes), a tensor handed over as it is, a failure of
  the worker raised in the caller's thread, a failed PNG render printed;
* the trainer's hooks: which protein is logged at which step;
* a two-epoch CLI run on the CPU writes the same file set as the JAX CLI
  with the same flags.

The port side runs on the CPU and never imports JAX: only this file does.
"""
import json
import os
import struct

import numpy as np
import pytest
import torch

from protein_transformer_tpu.protein import gltf as jgltf
from protein_transformer_tpu.protein import pdb as jpdb
from protein_transformer_tpu.training import structure_logging as jsl
from protein_transformer_tpu_torch.config import TrainConfig as TConfig
from protein_transformer_tpu_torch.data import synthetic as tsyn
from protein_transformer_tpu_torch.data.dataset import DataModule
from protein_transformer_tpu_torch.protein import gltf as tgltf
from protein_transformer_tpu_torch.protein import pdb as tpdb
from protein_transformer_tpu_torch.protein.vocab import VOCAB
from protein_transformer_tpu_torch.training import cli as tcli
from protein_transformer_tpu_torch.training import structure_logging as tsl
from protein_transformer_tpu_torch.training.trainer import Trainer

CPU = torch.device("cpu")
MODEL_ARGS = ["-m", "enc-only", "-dm", "32", "-dih", "64", "-nh", "2", "-nl",
              "1"]


def structure(seed, n_res, pad=0):
    """Ids of all amino acids (then ``pad`` padding rows), coordinates, and
    a mask with ~10% of the atoms missing."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.permutation(np.arange(n_res) % 20),
                          np.full(pad, VOCAB.pad_id)]).astype(np.int32)
    crd = rng.normal(0, 20, (n_res + pad, 14, 3)).astype(np.float32)
    mask = rng.random((n_res + pad, 14)) > 0.1
    mask[n_res:] = False
    return ids, crd, mask


def parse_glb(blob):
    """(gltf json, binary chunk) of a .glb, with its header checked."""
    magic, version, total = struct.unpack_from("<III", blob, 0)
    assert (magic, version, total) == (0x46546C67, 2, len(blob))
    json_len, json_type = struct.unpack_from("<II", blob, 12)
    assert json_type == 0x4E4F534A and json_len % 4 == 0
    gltf = json.loads(blob[20:20 + json_len])
    bin_len, bin_type = struct.unpack_from("<II", blob, 20 + json_len)
    assert bin_type == 0x004E4942
    body = blob[28 + json_len:]
    assert len(body) == bin_len == gltf["buffers"][0]["byteLength"]
    return gltf, body


@pytest.mark.parametrize("seed,n_res", [(0, 500), (1, 37), (2, 1)])
def test_pdb_lines_equal_the_jax_writers(seed, n_res):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWYX"), n_res))
    crd = rng.normal(0, 30, (n_res, 14, 3))
    crd[rng.random((n_res, 14)) < 0.1] = np.nan
    crd[rng.random((n_res, 14)) < 0.1] = 0.0
    for chain in (" ", "A", ""):
        assert (tpdb.PdbWriter(crd, seq, chain).lines("t")
                == jpdb.PdbWriter(crd, seq, chain).lines("t"))
    empty = np.zeros((n_res, 14, 3))
    assert (tpdb.PdbWriter(empty, seq).lines()
            == jpdb.PdbWriter(empty, seq).lines())


@pytest.mark.parametrize("seed,n_res", [(0, 40), (1, 7), (2, 1)])
def test_gltf_copy_equals_the_jax_packages(seed, n_res):
    ids, crd, mask = structure(seed, n_res)
    for dtype in (np.int32, np.int64):  # cached per sequence, by its bytes
        np.testing.assert_array_equal(
            tgltf.structure_bonds(ids.astype(dtype)),
            jgltf.structure_bonds(ids.astype(dtype)))
    assert tgltf.coords_to_glb(crd, ids) == jgltf.coords_to_glb(crd, ids)
    masked = tgltf.coords_to_glb(crd, ids, mask)
    assert masked == jgltf.coords_to_glb(crd, ids, mask)
    scene = [(crd, ids, None, None), (crd + 1.0, ids, mask,
                                      (0.55, 0.55, 0.55, 1.0))]
    blob = tgltf.scene_to_glb(scene)
    assert blob == jgltf.scene_to_glb(scene)
    gltf, body = parse_glb(masked)
    n_atoms = gltf["accessors"][0]["count"]
    assert 0 < n_atoms <= int(mask.sum())
    assert gltf["meshes"][0]["primitives"][0]["mode"] == 1
    assert len(body) >= n_atoms * (12 + 16)
    assert parse_glb(blob)[0]["accessors"][0]["count"] > n_atoms


def test_kabsch_align_matches_jax_and_undoes_a_rigid_motion():
    rng = np.random.default_rng(3)
    target = rng.normal(0, 10, (50, 3))
    angle = 0.7
    rot = np.array([[np.cos(angle), -np.sin(angle), 0],
                    [np.sin(angle), np.cos(angle), 0], [0, 0, 1.0]])
    mobile = target @ rot.T + np.array([3.0, -2.0, 5.0])
    tf, rmsd = tsl.kabsch_align(mobile, target)
    assert rmsd < 1e-9
    np.testing.assert_allclose(tf(mobile), target, atol=1e-9)
    noisy = mobile + rng.normal(0, 0.5, mobile.shape)
    tf, rmsd = tsl.kabsch_align(noisy, target)
    jtf, jrmsd = jsl.kabsch_align(noisy, target)
    assert rmsd == jrmsd and 0.3 < rmsd < 1.5
    np.testing.assert_array_equal(tf(noisy), jtf(noisy))


def files_under(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_logger_writes_what_the_jax_logger_writes(tmp_path):
    ids, true_crd, mask = structure(4, 30, pad=6)
    pred = true_crd + np.random.default_rng(5).normal(
        0, 1, true_crd.shape).astype(np.float32)
    ours = tsl.StructureLogger(str(tmp_path / "t"))
    theirs = jsl.StructureLogger(str(tmp_path / "j"))
    for step, offset in ((0, 0.0), (7, 0.5)):
        # the port's logger takes the device tensor itself
        ours.log(step, "train", ids, torch.from_numpy(pred + offset),
                 true_crd, mask)
        theirs.log(step, "train", ids, pred + offset, true_crd, mask)
    ours.close()
    theirs.close()
    got = files_under(tmp_path / "t")
    assert got == files_under(tmp_path / "j") == [
        f"structures/train/{name}" for name in (
            "00000_pred.glb", "00000_pred.pdb", "00000_scene.glb",
            "00007_pred.glb", "00007_pred.pdb", "00007_scene.glb",
            "true.glb", "true.pdb")]
    for rel in got:
        with open(tmp_path / "t" / rel, "rb") as f, \
                open(tmp_path / "j" / rel, "rb") as g:
            assert f.read() == g.read(), rel
    names, _, res_nums, xyz = tpdb.parse_pdb_atoms(
        str(tmp_path / "t" / "structures/train/00007_pred.pdb"))
    assert res_nums[-1] == 30 and np.isfinite(xyz).all()
    true_names = tpdb.parse_pdb_atoms(
        str(tmp_path / "t" / "structures/train/true.pdb"))[0]
    assert len(true_names) < len(names)  # missing atoms left out
    with open(tmp_path / "t" / "structures/train/00000_scene.glb", "rb") as f:
        parse_glb(f.read())


def test_logger_raises_its_workers_failure_in_the_callers_thread(tmp_path):
    logger = tsl.StructureLogger(str(tmp_path))
    ids, crd, mask = structure(6, 10)
    logger.log(0, "train", ids, crd[:, :3], crd, mask)  # 3 atoms a residue
    with pytest.raises(RuntimeError, match="worker failed") as err:
        logger.close()
    assert isinstance(err.value.__cause__, ValueError)
    with pytest.raises(RuntimeError, match="worker failed"):
        logger.log(1, "train", ids, crd, crd, mask)


def test_png_render_failure_is_printed_not_raised(tmp_path, monkeypatch,
                                                  capsys):
    def broken(*args, **kw):
        raise OSError("no display")

    monkeypatch.setattr(tsl, "render_structure_png", broken)
    logger = tsl.StructureLogger(str(tmp_path), save_pngs=True)
    ids, crd, mask = structure(7, 10)
    logger.log(3, "V10", ids, crd, crd, mask)
    logger.close()
    assert "png render failed: no display" in capsys.readouterr().out
    assert "structures/V10/00003_pred.pdb" in files_under(tmp_path)


def test_render_structure_png_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    ids, crd, mask = structure(8, 12)
    path = str(tmp_path / "x.png")
    tsl.render_structure_png(path, crd + 1.0, crd, mask)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


# ------------------------------------------------------ trainer hooks

@pytest.fixture(scope="module")
def data():
    d = tsyn.make_dataset(n_train=12, n_eval=5, min_len=20, max_len=48,
                          seed=3)
    for split in [k for k in d if k.startswith("valid-")]:
        if split != "valid-10":
            del d[split]
    return d


def test_trainer_logs_the_expected_proteins_at_the_expected_steps(
        data, tmp_path):
    cfg = TConfig(model="enc-only", d_model=32, d_ff=64, n_heads=2,
                  n_layers=1, batch_size=1, repeat_train=5, loss="mse",
                  dropout=0.1, log_structure_step=2, log_val_struct_step=3,
                  out_dir=str(tmp_path), name="hooks", cluster=True)
    tr = Trainer(cfg, device=CPU, data=data)
    logged = []
    tr.structure_logger.log = lambda *args: logged.append(args)
    state = tr.init_state(torch.Generator().manual_seed(0))
    batches = list(tr.dm.train_batches(np.random.default_rng(cfg.seed)))
    state = tr.train_epoch(state)
    assert state.step == len(batches) >= 3
    steps = {"train": [s for s in range(state.step) if s % 2 == 0],
             "V10": [s for s in range(state.step) if s % 3 == 0]}
    for name, want_steps in steps.items():
        got = [item for item in logged if item[1] == name]
        assert [item[0] for item in got] == want_steps
        for step, _, seq, pred, true_crd, true_mask in got:
            if name == "train":
                batch = batches[step]
                row = int(batch.protein_mask.sum()) - 1
                want = (batch.seq[row], batch.crd[row], batch.crd_mask[row])
            else:
                ds = tr.dm.eval_splits["valid-10"]
                mid = len(ds) // 2
                want = (np.asarray(ds.seq_enc[mid]), None, None)
                seq = seq[:len(want[0])]
            np.testing.assert_array_equal(seq, want[0])
            if want[1] is not None:
                np.testing.assert_array_equal(true_crd, want[1])
                np.testing.assert_array_equal(true_mask, want[2])
            assert isinstance(pred, torch.Tensor) and not pred.requires_grad
            assert pred.shape == true_crd.shape
            assert torch.isfinite(pred).all()
    assert tr.model.training  # the next step's mode, after an eval-mode log
    # cadence 0 switches a hook off
    logged.clear()
    tr.cfg.log_structure_step = tr.cfg.log_val_struct_step = 0
    tr.train_epoch(state)
    assert not logged


def test_cli_writes_the_file_set_of_the_jax_cli(data, tmp_path):
    """Two epochs in both packages with the same flags. Each run logs four
    structures in all (train and validation, two steps each), never more
    than the logger's queue holds, so nothing can be dropped."""
    from protein_transformer_tpu.training import cli as jcli
    data_path = str(tmp_path / "data.pt")
    torch.save(data, data_path)
    flags = [*MODEL_ARGS, "-e", "2", "-b", "1", "--repeat_train", "3", "-l",
             "mse", "--cluster", "True", "--data", data_path, "--out_dir",
             str(tmp_path)]
    dm = DataModule(data, tcli.config_from_args(flags))
    steps = len(list(dm.train_index_batches(np.random.default_rng(
        tcli.config_from_args(flags).seed))))
    assert steps >= 2
    flags += ["--log_structure_step", str(steps), "-lvs", str(steps + 1)]
    tcli.main(flags + ["--name", "port", "--device", "cpu"])
    jcli.main(flags + ["--name", "jax", "--device_data", "false"])
    ours = files_under(tmp_path / "port" / "structures")
    assert ours == files_under(tmp_path / "jax" / "structures")
    assert ours == sorted(
        f"{name}/{f}" for name, logged in (("train", (0, steps)),
                                           ("V10", (0, steps + 1)))
        for f in ["true.glb", "true.pdb"] + [
            f"{s:05d}_{kind}" for s in logged
            for kind in ("pred.glb", "pred.pdb", "scene.glb")])
    for rel in ours:
        path = str(tmp_path / "port" / "structures" / rel)
        if rel.endswith(".glb"):
            with open(path, "rb") as f:
                parse_glb(f.read())
        else:
            assert np.isfinite(tpdb.parse_pdb_atoms(path)[3]).all()
    # the true structure is the same protein in both runs
    for name in ("train", "V10"):
        with open(tmp_path / "port" / "structures" / name / "true.pdb") as f, \
                open(tmp_path / "jax" / "structures" / name
                     / "true.pdb") as g:
            assert f.read() == g.read()
