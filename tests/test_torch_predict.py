"""The port's predict entry point and PDB writer against the JAX package's.

* ``PdbWriter.lines`` string for string on seeded coordinates with NaN and
  all-zero atoms, and the ``parse_pdb_atoms`` round trip;
* the slice as a whole: the JAX CLI trains a tiny model on the CPU, the run
  is exported (``ptt_scripts/export_checkpoint_npz.py``), imported as a run
  directory of the port (``training.checkpoint.import_run``), and both
  ``predict`` entry points write the same split: the same file names, the
  ``*_true.pdb`` files equal byte for byte, the ``*_pred.pdb`` coordinates
  equal atom by atom within 2e-3 A (the repo's 1e-3 A coordinate gate plus
  the rounding of the file's three decimals on both sides), once with
  ``attention_impl`` xla and once with flash in the port's config;
* predict from a run that the port's own CLI trained, and ``--reconstruct``.

The port side runs on the CPU (``--device cpu``) and never imports JAX:
only this test file does.
"""
import dataclasses
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from protein_transformer_tpu.protein import pdb as jpdb
from protein_transformer_tpu_torch import predict as tpredict
from protein_transformer_tpu_torch.config import TrainConfig as TConfig
from protein_transformer_tpu_torch.data import synthetic as tsyn
from protein_transformer_tpu_torch.models.factory import make_model
from protein_transformer_tpu_torch.ops import attention as A
from protein_transformer_tpu_torch.protein import pdb as tpdb
from protein_transformer_tpu_torch.protein.vocab import STD_AAS
from protein_transformer_tpu_torch.training import checkpoint as tckpt
from protein_transformer_tpu_torch.training import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_ARGS = ["-m", "enc-only", "-dm", "32", "-dih", "64", "-nh", "2", "-nl",
              "1"]


def seeded_coords(seed, n_res):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.permutation(list(STD_AAS) * 2)[:n_res])
    crd = rng.normal(0, 30, (n_res, 14, 3)).astype(np.float32)
    crd[rng.random((n_res, 14)) < 0.1] = np.nan
    crd[rng.random((n_res, 14)) < 0.1] = 0.0
    crd[3, 5, 1] = np.nan  # one coordinate of an atom is enough to drop it
    return seq, crd


@pytest.mark.parametrize("case", ["L14-flat", "L30-chainA", "L40"])
def test_pdb_lines_equal_the_jax_packages(case):
    n_res = int(case.split("-")[0][1:])
    seq, crd = seeded_coords(n_res, n_res)
    chain = "A" if "chainA" in case else " "
    if "flat" in case:
        crd = crd.reshape(-1, 3)
    ours = tpdb.PdbWriter(crd, seq, chain).lines(title=f"pred {case}")
    theirs = jpdb.PdbWriter(crd, seq, chain).lines(title=f"pred {case}")
    assert ours == theirs
    assert ours[0] == f"REMARK  pred {case}" and ours[-2:] == ["TER",
                                                              "END          "]
    n_atoms = sum(line.startswith("ATOM") for line in ours)
    assert 0 < n_atoms < n_res * 14
    assert tpdb.atom_names_for_seq(seq) == jpdb.atom_names_for_seq(seq)


def test_pdb_round_trip_and_shape_check(tmp_path):
    seq, crd = seeded_coords(1, 25)
    path = str(tmp_path / "x.pdb")
    tpdb.PdbWriter(crd, seq).save_pdb(path, title="t")
    names, res_names, res_nums, xyz = tpdb.parse_pdb_atoms(path)
    j_names, j_res, j_nums, j_xyz = jpdb.parse_pdb_atoms(path)
    assert (names, res_names, res_nums) == (j_names, j_res, j_nums)
    assert np.array_equal(xyz, j_xyz)
    keep = ~(np.isnan(crd).any(-1) | (crd == 0).all(-1))
    want_names = [n for row, k in zip(tpdb.atom_names_for_seq(seq), keep)
                  for n, kept in zip(row, k) if n and kept]
    assert names == want_names
    want_xyz = np.concatenate([
        crd[i][[bool(n) and kept for n, kept in
                zip(tpdb.atom_names_for_seq(seq)[i], keep[i])]]
        for i in range(len(seq))])
    np.testing.assert_allclose(xyz, want_xyz, atol=5.1e-4)
    assert res_nums[0] == 1 and res_nums[-1] <= len(seq)
    with pytest.raises(ValueError, match="residues"):
        tpdb.PdbWriter(crd, seq[:-1])


# ------------------------------------------------------------- the slice

def read_pdbs(paths):
    return {os.path.basename(p): tpdb.parse_pdb_atoms(p) for p in paths}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One dataset file; a JAX run trained by the JAX CLI, its export, and
    the JAX predict's files for the test split."""
    from protein_transformer_tpu import predict as jpredict
    from protein_transformer_tpu.training import cli as jcli
    root = tmp_path_factory.mktemp("predict")
    data_path = str(root / "data.pt")
    torch.save(tsyn.make_dataset(n_train=12, n_eval=5, min_len=20,
                                 max_len=48, seed=3), data_path)
    # Adam at a large rate for a few steps: the output head starts at zero
    # weight, and must move far enough for the trunk to reach the angles
    jcli.main(["--data", data_path, "--name", "jrun", "--out_dir", str(root),
               *MODEL_ARGS, "-e", "2", "-b", "4", "-l", "mse", "-opt",
               "adam", "-lr", "0.01", "--train_only", "--log_structure_step",
               "0", "-lvs", "0", "--cluster", "True"])
    jax_run = str(root / "jrun")
    spec = importlib.util.spec_from_file_location(
        "export_checkpoint_npz",
        os.path.join(ROOT, "ptt_scripts", "export_checkpoint_npz.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    exported = str(root / "exported")
    export.main([jax_run, exported])
    jax_out = str(root / "jax_preds")
    jpredict.main([jax_run, "--data", data_path, "--split", "test", "--n",
                   "5", "--out", jax_out, "--batch", "4"])
    jax_files = sorted(os.path.join(jax_out, f) for f in os.listdir(jax_out))
    return {"root": root, "data": data_path, "exported": exported,
            "jax_files": jax_files}


def test_exported_checkpoint_is_plain_numpy(runs):
    with np.load(os.path.join(runs["exported"], "best.npz")) as z:
        keys = list(z.files)
        assert "step" in keys and int(z["step"]) > 0
        assert all(k == "step" or k.startswith("params/params/")
                   for k in keys)
        assert "params/params/AngleProjection_0/output_projection/kernel" \
            in keys
        head = z["params/params/AngleProjection_0/output_projection/kernel"]
        assert np.abs(head).max() > 1e-2  # training moved the zero head
    for name in ("config.json", "best.meta.json"):
        assert os.path.isfile(os.path.join(runs["exported"], name))


@pytest.mark.parametrize("attention_impl", ["xla", "flash"])
def test_predict_matches_jax_predict_from_an_exported_run(
        runs, attention_impl, monkeypatch, capsys):
    run_dir = str(runs["root"] / f"port_{attention_impl}")
    tckpt.main([runs["exported"], run_dir])
    cfg_path = os.path.join(run_dir, "config.json")
    with open(cfg_path) as f:
        saved = json.load(f)
    assert saved["config"]["drmsd_impl"] == "auto"
    assert saved["config"]["attention_impl"] == "auto"
    saved["config"]["attention_impl"] = attention_impl
    with open(cfg_path, "w") as f:
        json.dump(saved, f)
    flash_calls = []
    plain = A.flash_self_attention_torch

    def counting(*args, **kw):
        flash_calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(A, "flash_self_attention_torch", counting)
    out = str(runs["root"] / f"preds_{attention_impl}")
    capsys.readouterr()
    paths = tpredict.main([run_dir, "--data", runs["data"], "--split",
                           "test", "--n", "5", "--out", out, "--batch", "4",
                           "--device", "cpu"])
    # 5 proteins in batches of 4: two batches, one encoder layer each
    assert len(flash_calls) == (2 if attention_impl == "flash" else 0)
    assert capsys.readouterr().out.split() == paths
    assert sorted(map(os.path.basename, paths)) \
        == sorted(map(os.path.basename, runs["jax_files"]))
    assert len(paths) == 10
    ours, theirs = read_pdbs(paths), read_pdbs(runs["jax_files"])
    worst = 0.0
    for path in runs["jax_files"]:
        name = os.path.basename(path)
        if name.endswith("_true.pdb"):
            with open(path) as f, open(os.path.join(out, name)) as g:
                assert f.read() == g.read(), name
            continue
        assert ours[name][:3] == theirs[name][:3], name
        assert len(ours[name][3]) > 20 * 4
        worst = max(worst, float(np.abs(ours[name][3]
                                        - theirs[name][3]).max()))
    assert worst <= 2e-3, f"pred coordinates differ by {worst:.3e} A"


def test_imported_checkpoint_holds_the_exported_parameters(runs):
    run_dir = tckpt.import_run(runs["exported"],
                               str(runs["root"] / "port_params"))
    cfg, model = tpredict.load_run(run_dir, device="cpu")
    assert (cfg.model, cfg.d_model, cfg.n_layers) == ("enc-only", 32, 1)
    assert not model.training
    arrays, meta = tckpt.CheckpointManager(
        os.path.join(run_dir, "checkpoints")).restore_raw("best")
    assert meta["epoch"] >= 0 and arrays["step"] > 0
    assert arrays["opt_state"] == {"count": 0, "mu": {}, "nu": {}}
    with np.load(os.path.join(runs["exported"], "best.npz")) as z:
        head = z["params/params/AngleProjection_0/output_projection/kernel"]
        wq = z["params/params/Encoder_0/EncoderLayer_0/"
               "MultiHeadedAttention_0/wq/kernel"]
    state = model.state_dict()
    assert np.array_equal(state["head.output_projection.weight"].numpy(),
                          head.T)
    assert np.array_equal(state["encoder.layers.0.attn.wq.weight"].numpy(),
                          wq.T)
    with pytest.raises(FileNotFoundError, match="no 'latest' checkpoint"):
        tpredict.load_run(run_dir, "latest", device="cpu")


def with_setting(run_dir, dest, key, value):
    """A copy of ``run_dir`` whose config.json sets ``key`` to ``value``."""
    shutil.copytree(run_dir, dest)
    cfg_path = os.path.join(dest, "config.json")
    with open(cfg_path) as f:
        saved = json.load(f)
    assert key in saved["config"]
    saved["config"][key] = value
    with open(cfg_path, "w") as f:
        json.dump(saved, f)
    return str(dest)


def test_import_takes_a_bfloat16_run(runs, tmp_path):
    """A run trained with --compute_dtype bfloat16 holds float32 parameters,
    as a float32 run does, so its export imports them unchanged; the
    imported model computes in bf16 and gives the JAX bf16 model's outputs
    from the same parameters (the JAX model op by op, as its flax modules
    cast), held by tests/test_torch_bf16.py's gate against bf16's own
    error."""
    from protein_transformer_tpu import predict as jpredict
    from test_torch_bf16 import hold_to_jax_bf16
    exported = with_setting(runs["exported"], tmp_path / "exported",
                            "compute_dtype", "bfloat16")
    run_dir = tckpt.import_run(exported, str(tmp_path / "run"))
    cfg, model = tpredict.load_run(run_dir, device="cpu")
    assert cfg.compute_dtype == "bfloat16"
    with np.load(os.path.join(exported, "best.npz")) as z:
        wq = z["params/params/Encoder_0/EncoderLayer_0/"
               "MultiHeadedAttention_0/wq/kernel"]
    state = model.state_dict()
    assert {v.dtype for v in state.values()} == {torch.float32}
    assert np.array_equal(state["encoder.layers.0.attn.wq.weight"].numpy(),
                          wq.T)
    seen = []
    model.encoder.layers[0].ff.w_1.register_forward_hook(
        lambda _m, _in, out: seen.append(out.dtype))
    ids = np.random.default_rng(0).integers(0, 20, (2, 24)).astype(np.int32)
    ids[1, 15:] = 20
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    assert seen == [torch.bfloat16] and got.dtype == torch.float32
    jax_run = with_setting(str(runs["root"] / "jrun"), tmp_path / "jrun",
                           "compute_dtype", "bfloat16")
    jcfg, jmodel, params = jpredict.load_run(jax_run)
    assert jcfg.compute_dtype == "bfloat16"
    want = np.asarray(jmodel.apply({"params": params["params"]}, ids))
    fp32_model = make_model(dataclasses.replace(cfg, compute_dtype="float32"),
                            np.zeros(24, np.float32))
    fp32_model.load_state_dict(state)
    with torch.no_grad():
        fp32 = fp32_model.eval()(torch.from_numpy(ids)).numpy()
    hold_to_jax_bf16(got.numpy(), want, fp32, ids != 20)


@pytest.mark.parametrize("key,value,match", [
    ("model", "enc-dec", (KeyError, "which the model does not have")),
    ("mesh_shape", [4], None), ("use_wandb", True, None)])
def test_import_refuses_what_changes_the_models_results(runs, tmp_path, key,
                                                        value, match):
    """A run trained with a setting the port lacks is not imported as if
    it were a float32 encoder run, nor are an encoder's parameters imported
    under another model family's name; settings that only say how the JAX
    run was executed are dropped where the port has no field for them and
    kept where it has (the mesh, wandb logging)."""
    exported = str(tmp_path / "exported")
    shutil.copytree(runs["exported"], exported)
    cfg_path = os.path.join(exported, "config.json")
    with open(cfg_path) as f:
        saved = json.load(f)
    assert key in saved["config"]
    saved["config"][key] = value
    with open(cfg_path, "w") as f:
        json.dump(saved, f)
    run_dir = str(tmp_path / "run")
    if match is None:
        assert tckpt.import_run(exported, run_dir) == run_dir
        with open(os.path.join(run_dir, "config.json")) as f:
            imported = json.load(f)["config"]
        if key in {f.name for f in dataclasses.fields(TConfig)}:
            assert imported[key] == value
        else:
            assert key not in imported
        return
    with pytest.raises(match[0], match=match[1]):
        tckpt.import_run(exported, run_dir)
    assert not os.path.exists(run_dir)


@pytest.fixture(scope="module")
def port_run(runs):
    """A run that the port's own CLI trained on the CPU, with flash
    attention in its config."""
    tcli.main(["--data", runs["data"], "--name", "trun", "--out_dir",
               str(runs["root"]), *MODEL_ARGS, "-e", "1", "-b", "4", "-l",
               "mse", "-opt", "adam", "-lr", "0.01", "--train_only",
               "--cluster", "True", "--attention_impl", "flash", "--device",
               "cpu"])
    return str(runs["root"] / "trun")


def test_predict_from_a_run_of_the_ports_own_cli(runs, port_run, tmp_path):
    with open(os.path.join(port_run, "config.json")) as f:
        assert json.load(f)["config"]["attention_impl"] == "flash"
    out = str(tmp_path / "preds")
    paths = tpredict.predict_structures(port_run, runs["data"], "valid-10",
                                        n=3, out_dir=out, batch_size=2,
                                        device="cpu")
    assert [os.path.basename(p) for p in paths[:2]] \
        == [os.path.basename(paths[0]).replace("_true", "_pred"),
            os.path.basename(paths[0]).replace("_pred", "_true")]
    assert len(paths) == 6 and all(os.path.isfile(p) for p in paths)
    for name, (names, res_names, res_nums, xyz) in read_pdbs(paths).items():
        assert len(names) == len(xyz) > 20 and np.isfinite(xyz).all(), name
        assert res_nums == sorted(res_nums)
    # the same run with the materialised attention gives the same files
    xla_run = str(tmp_path / "xla_run")
    shutil.copytree(port_run, xla_run)
    cfg_path = os.path.join(xla_run, "config.json")
    with open(cfg_path) as f:
        saved = json.load(f)
    saved["config"]["attention_impl"] = "xla"
    with open(cfg_path, "w") as f:
        json.dump(saved, f)
    xla_paths = tpredict.predict_structures(
        xla_run, runs["data"], "valid-10", n=3,
        out_dir=str(tmp_path / "xla_preds"), batch_size=2, device="cpu")
    for a, b in zip(paths, xla_paths):
        np.testing.assert_allclose(tpdb.parse_pdb_atoms(a)[3],
                                   tpdb.parse_pdb_atoms(b)[3], atol=2e-3)


def test_reconstruct_rebuilds_the_true_structures(runs, port_run, tmp_path):
    out = str(tmp_path / "recon")
    paths = tpredict.main([port_run, "--data", runs["data"], "--split",
                           "train", "--n", "2", "--reconstruct", "--out", out,
                           "--device", "cpu"])
    recon = [p for p in paths if p.endswith("_recon.pdb")]
    assert len(recon) == 2 and len(paths) == 4
    for path in recon:
        r_names, r_res, r_nums, r_xyz = tpdb.parse_pdb_atoms(path)
        t_names, t_res, t_nums, t_xyz = tpdb.parse_pdb_atoms(
            path.replace("_recon.pdb", "_true.pdb"))
        built = {(n, a): x for n, a, x in zip(r_nums, r_names, r_xyz)}
        # the true file lacks the atoms stored as missing; every atom it
        # has was built from the true angles at the same place
        assert len(t_xyz) <= len(r_xyz)
        err = max(float(np.abs(built[(n, a)] - x).max())
                  for n, a, x in zip(t_nums, t_names, t_xyz))
        assert err <= 2e-3, err


def test_predict_without_a_gpu_raises_and_never_uses_the_cpu(runs, port_run,
                                                             tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpredict.main([port_run, "--data", runs["data"], "--out",
                       str(tmp_path / "never")])
    # the functions a Python caller uses pick the GPU too when no device is
    # named, and raise before anything is written
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpredict.predict_structures(port_run, runs["data"],
                                    out_dir=str(tmp_path / "never"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpredict.load_run(port_run)
    assert not os.path.exists(tmp_path / "never")
