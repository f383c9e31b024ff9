"""The port's six analysis and dataset scripts against their ptt_scripts
originals, on the same small synthetic dataset and the same seed.

* ``compute_dataset_angle_means``: the same means and the same line;
* ``downsample_dataset`` and ``create_development_datasets`` (by id and
  with ``--any_split``): the same items, split by split;
* ``group_predictions`` on predict-style ``<id>_pred.pdb`` /
  ``<id>_true.pdb`` pairs (and a ``_recon`` one): ``summary.tsv`` and
  every grouped PDB file byte-equal, the same printed lines;
* ``analyze`` and ``plot`` (its text summary, matplotlib kept out in both)
  on CSV logs written by the port's ``CsvLogger``: the same output.

Cost: ~5 s in one worker (numpy on the host; no JAX compile).
"""
import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from protein_transformer_tpu_torch.data.dataset import (
    ALL_SPLITS, load_dataset)
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.protein.pdb import PdbWriter
from protein_transformer_tpu_torch.protein.vocab import VOCAB
from protein_transformer_tpu_torch.scripts import (
    analyze, compute_dataset_angle_means, create_development_datasets,
    downsample_dataset, group_predictions, plot)
from protein_transformer_tpu_torch.training.metrics import CsvLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def original(name):
    """The ptt_scripts module ``name``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"ptt_original_{name}", os.path.join(ROOT, "ptt_scripts",
                                             f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A .pt dataset of all nine splits with ids, and its path."""
    data = make_dataset(n_train=8, n_eval=3, min_len=12, max_len=30, seed=3)
    for split in ALL_SPLITS:
        n = len(data[split]["seq"])
        data[split]["ids"] = [f"{split[:5].upper()}{i:02d}_1_A"
                              for i in range(n)]
    path = str(tmp_path_factory.mktemp("data") / "data.pt")
    torch.save(data, path)
    return path


def same_items(a: dict, b: dict) -> None:
    splits = [k for k in a if isinstance(a[k], dict) and "seq" in a[k]]
    assert splits == [k for k in b if isinstance(b[k], dict) and "seq" in b[k]]
    for split in splits:
        assert a[split]["ids"] == b[split]["ids"], split
        assert a[split]["seq"] == b[split]["seq"], split
        for key in ("ang", "crd"):
            assert len(a[split][key]) == len(b[split][key])
            for x, y in zip(a[split][key], b[split][key]):
                np.testing.assert_array_equal(x, y)
    assert a["settings"].keys() == b["settings"].keys()


def test_angle_means_equal(dataset, tmp_path):
    mine, theirs = str(tmp_path / "mine.npy"), str(tmp_path / "theirs.npy")
    out = printed(compute_dataset_angle_means.main, [dataset, mine])
    want = printed(original("compute_dataset_angle_means").main,
                   [dataset, theirs])
    np.testing.assert_array_equal(np.load(mine), np.load(theirs))
    assert out.replace(mine, "X") == want.replace(theirs, "X")


@pytest.mark.parametrize("flags", [["--n", "2", "--seed", "5"],
                                   ["--fraction", "0.5"]])
def test_downsampled_datasets_hold_the_same_items(dataset, tmp_path, flags):
    printed(downsample_dataset.main, [dataset, str(tmp_path / "m"), *flags])
    printed(original("downsample_dataset").main,
            [dataset, str(tmp_path / "t"), *flags])
    mine, theirs = (load_dataset(str(tmp_path / d)) for d in ("m", "t"))
    same_items(mine, theirs)
    assert len(mine["train"]["seq"]) == (2 if "--n" in flags else 4)


@pytest.mark.parametrize("ids,flags", [
    (["TRAIN01_1_A", "TRAIN05_1_A"], []),
    (["TRAIN03"], []),                        # by substring
    (["TEST_02", "VALID01", "TRAIN07"], ["--any_split"])])
def test_development_datasets_hold_the_same_items(dataset, tmp_path, ids,
                                                  flags):
    ids_file = tmp_path / "ids.txt"
    ids_file.write_text("\n".join(ids) + "\n")
    args = [dataset, str(ids_file)]
    printed(create_development_datasets.main, [*args, str(tmp_path / "m"),
                                               *flags])
    printed(original("create_development_datasets").main,
            [*args, str(tmp_path / "t"), *flags])
    mine, theirs = (load_dataset(str(tmp_path / d)) for d in ("m", "t"))
    same_items(mine, theirs)
    assert mine["train"]["ids"] == mine["test"]["ids"] == mine[
        "valid-70"]["ids"] and mine["train"]["ids"]


def test_development_dataset_without_a_match_raises(dataset):
    with pytest.raises(ValueError, match="none of the requested ids"):
        create_development_datasets.make_dev_dataset(load_dataset(dataset),
                                                     ["NOPE"])


@pytest.fixture(scope="module")
def predictions(dataset, tmp_path_factory):
    """predict-style files: <id>_true.pdb beside <id>_pred.pdb (the true
    structure moved and perturbed by a seeded amount per protein), and one
    pair with a _recon.pdb instead."""
    data = load_dataset(dataset)["test"]
    out = tmp_path_factory.mktemp("preds")
    rng = np.random.default_rng(0)
    for i, (pid, seq, crd) in enumerate(zip(data["ids"], data["seq"],
                                            data["crd"])):
        seq = seq if isinstance(seq, str) else VOCAB.ints2str(seq)
        crd = np.nan_to_num(np.asarray(crd, np.float64))
        PdbWriter(crd, seq).save_pdb(str(out / f"{pid}_true.pdb"), "true")
        angle = rng.uniform(0, np.pi)
        rot = np.array([[np.cos(angle), -np.sin(angle), 0],
                        [np.sin(angle), np.cos(angle), 0], [0, 0, 1]])
        moved = crd @ rot.T + rng.normal(0, 20, 3)
        moved += rng.normal(0, [0.5, 3.0, 12.0][i % 3], crd.shape)
        moved[(crd == 0).all(-1)] = 0.0
        kind = "recon" if i == 2 else "pred"
        PdbWriter(moved, seq).save_pdb(str(out / f"{pid}_{kind}.pdb"))
    return str(out)


def test_grouped_predictions_are_byte_equal(predictions, tmp_path):
    mine, theirs = str(tmp_path / "m"), str(tmp_path / "t")
    out = printed(group_predictions.main, [predictions, "--out", mine])
    want = printed(original("group_predictions").main,
                   [predictions, "--out", theirs])
    assert out.replace(mine, "X") == want.replace(theirs, "X")
    with open(os.path.join(mine, "summary.tsv")) as f:
        summary = f.read()
    with open(os.path.join(theirs, "summary.tsv")) as f:
        assert summary.replace(mine, "X") == f.read().replace(theirs, "X")
    rows = summary.splitlines()[1:]
    assert len(rows) == 3 and {r.split("\t")[2] for r in rows} <= {
        "excellent", "good", "fair", "poor"}
    files = sorted(os.path.relpath(os.path.join(d, f), mine)
                   for d, _, fs in os.walk(mine) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), theirs)
                           for d, _, fs in os.walk(theirs) for f in fs)
    for rel in files:
        if rel.endswith(".pdb"):
            with open(os.path.join(mine, rel), "rb") as a, \
                    open(os.path.join(theirs, rel), "rb") as b:
                assert a.read() == b.read(), rel


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two run directories with .train CSVs written by the port's
    CsvLogger (combined and lndrmsd) and config.json files."""
    base = tmp_path_factory.mktemp("runs")
    rng = np.random.default_rng(1)
    dirs = []
    for name, loss, d_model in (("run_a", "combined", 64),
                                ("run_b", "lndrmsd", 128)):
        run = base / name
        run.mkdir()
        logger = CsvLogger(str(run / f"{name}.train"), loss)
        metrics = {"history-lr": [1e-3]}
        for step in range(30):
            for mode, end in (("train", False), ("train", step % 10 == 9),
                              ("valid-70", step % 10 == 9)):
                metrics[mode] = {
                    f"{g}-{k}": float(rng.uniform(0.1, 30))
                    for g in ("batch", "epoch")
                    for k in ("drmsd-full", "lndrmsd-full", "mse-full",
                              "rmsd-full", "combined-full")}
                metrics[mode]["speed"] = 1000.0
                if mode == "train" or end:
                    logger.log(metrics, mode, 0.0, end_of_epoch=end)
        logger.close()
        (run / "config.json").write_text(json.dumps(
            {"config": {"model": "conv-enc", "d_model": d_model,
                        "loss": loss}}))
        dirs.append(str(run))
    return dirs


@pytest.mark.parametrize("flags", [[], ["--mode", "valid-70", "--metric",
                                        "drmsd"]])
def test_analyze_prints_what_the_original_prints(runs, flags):
    assert (printed(analyze.main, [*runs, *flags])
            == printed(original("analyze").main, [*runs, *flags]))


@pytest.mark.parametrize("flags", [[], ["--metric", "rmse", "--mode",
                                        "valid-70"]])
def test_plot_text_summary_equals_the_originals(runs, flags, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # ImportError
    log = os.path.join(runs[0], "run_a.train")
    out = printed(plot.main, [log, *flags])
    assert out == printed(original("plot").main, [log, *flags])
    assert out.count("first=") == (1 if flags else 5)
    assert plot.main([log, "--mode", "test"]) == 1
