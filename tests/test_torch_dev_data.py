"""The port's native-directory loader and its eval step on real chains,
against the JAX package.

``examples/dev_data`` holds real protein chains in the native shard layout
(a manifest and one .npz per split), with NaN angles and missing atoms. Both
packages load it; the dicts must agree key by key and array by array. Then
one eval step of each package, at small width with the same weights
through the flax bridge, on a batch of its training chains: the masks carry
the NaN angles and the missing atoms. Gates: MSE within 1e-5, the dRMSD
family and RMSD within the project's 1e-3 A (the two NeRF builders compose
in different orders). Then one epoch of each package's CLI on its training
chains (``--train_only``), each on its default data path, the device store, from the
same weights at dropout 0: the NaN angles and missing atoms reach the
training losses through the masks; the CSV files have the same columns and
rows, and the losses agree within the A/B bound of tests/test_torch_loop.py
(2e-5 relative plus 1e-6 absolute).
"""
import csv
import os

import jax
import numpy as np
import pytest
import torch

from protein_transformer_tpu.config import TrainConfig as JConfig
from protein_transformer_tpu.training import cli as jcli
from protein_transformer_tpu.data.dataset import collate as jcollate
from protein_transformer_tpu.data.dataset import load_dataset as jload
from protein_transformer_tpu.training.trainer import Trainer as JTrainer
from protein_transformer_tpu_torch.config import TrainConfig as TConfig
from protein_transformer_tpu_torch.data.dataset import collate, load_dataset
from protein_transformer_tpu_torch.models.flax_import import (
    flax_to_state_dict)
from protein_transformer_tpu_torch.training import cli as tcli
from protein_transformer_tpu_torch.training.trainer import (
    METRIC_KEYS, Trainer as TTrainer, unpack_metrics)

DEV_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "dev_data")
SPLITS = ("train", "valid-70", "test")
CONFIG = dict(model="conv-enc|5,3|1,1", d_model=32, d_ff=64, n_heads=2,
              n_layers=2, batch_size=4, loss="combined", bucket_sizes=(64,),
              max_seq_len=64)


@pytest.fixture(scope="module")
def loaded():
    return load_dataset(DEV_DATA), jload(DEV_DATA)


def test_native_loader_matches_jax(loaded):
    got, want = loaded
    assert set(got) == set(want) == {"settings", "date", *SPLITS}
    assert got["date"] == want["date"]
    assert set(got["settings"]) == set(want["settings"])
    for key, value in want["settings"].items():
        np.testing.assert_equal(got["settings"][key], value, key)
    for split in SPLITS:
        assert set(got[split]) == set(want[split]) == {"seq", "ang", "crd",
                                                       "ids"}
        assert got[split]["seq"] == want[split]["seq"]
        assert got[split]["ids"] == want[split]["ids"]
        for field in ("ang", "crd"):
            assert len(got[split][field]) == len(want[split][field])
            for g, w in zip(got[split][field], want[split][field]):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)  # NaN where NaN
    # real chains: NaN angles and missing atoms in every split
    for split in SPLITS:
        assert any(np.isnan(a).any() for a in got[split]["ang"])
        assert any(np.isnan(c).any() for c in got[split]["crd"])


def test_eval_step_on_real_chains_matches_jax(loaded, tmp_path):
    got_data, want_data = loaded
    jtr = JTrainer(JConfig(**CONFIG, out_dir=str(tmp_path), name="dev"),
                   data=want_data, use_mesh=False)
    params = jax.tree_util.tree_map(np.asarray, jtr.init_state().params)
    # a random output head, so the trunk reaches the outputs
    head = params["params"]["AngleProjection_0"]["output_projection"]
    head["kernel"] = np.random.default_rng(0).normal(
        0, 0.3, head["kernel"].shape).astype(np.float32)
    ttr = TTrainer(TConfig(**CONFIG), device=torch.device("cpu"),
                   data=got_data)
    tparams = flax_to_state_dict(params, ttr.model)

    idx = np.arange(4)
    batch = collate(ttr.dm.train, idx, ttr.cfg.bucket_sizes,
                    ttr.dm.max_seq_len)
    jbatch = jcollate(jtr.dm.train, idx, jtr.cfg.bucket_sizes,
                      jtr.dm.max_seq_len)
    for field in ("seq", "ang", "ang_mask", "crd", "crd_mask",
                  "protein_mask", "n_res"):
        np.testing.assert_array_equal(getattr(batch, field),
                                      getattr(jbatch, field))
    real = batch.seq != ttr.cfg.pad_id
    assert not batch.ang_mask[real].all() and not batch.crd_mask[real].all()

    step = jtr._jit_cache.setdefault("eval", jtr._eval_step_fn())
    want = unpack_metrics(np.asarray(step(params, jbatch)))
    got = unpack_metrics(ttr.eval_step(tparams, batch).numpy())
    assert set(got) == set(METRIC_KEYS)
    for key in METRIC_KEYS:
        gate = 1e-5 if key.startswith("mse") else 1e-3
        assert np.isfinite(got[key]), key
        assert abs(got[key] - want[key]) <= gate, (key, got[key], want[key])
    assert got["drmsd-full"] > 0 and got["mse-full"] > 0


CLI = ["--data", DEV_DATA, "-m", "conv-enc|5,3|1,1", "-dm", "32", "-dih",
       "64", "-nh", "2", "-nl", "1", "-do", "0", "-e", "1", "-b", "1",
       "--repeat_train", "3", "--bins", "1", "-l", "combined", "-opt", "adam",
       "-lr", "1e-3", "--cluster", "True", "--log_structure_step", "0",
       "-lvs", "0", "--train_only"]


def read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_one_cli_epoch_on_real_chains_matches_jax(loaded, tmp_path,
                                                  monkeypatch):
    argv = CLI + ["--out_dir", str(tmp_path)]
    # the JAX CLI's weights: its trainer draws them from the seed alone
    jtr = JTrainer(jcli.config_from_args(argv + ["--name", "w"]),
                   data=loaded[1], use_mesh=False)
    params = jax.tree_util.tree_map(np.asarray, jtr.init_state().params)
    built = []

    def bridged(self, generator):
        built.append(self.use_device_data)
        return self.state_from(flax_to_state_dict(params, self.model))

    monkeypatch.setattr(TTrainer, "init_state", bridged)
    tcli.main(argv + ["--name", "port", "--device", "cpu"])
    # one device: the JAX CLI's default mesh spans the eight virtual CPU
    # devices of the test process, which only makes its compile slower
    jcli.main(argv + ["--name", "jax", "--mesh_shape", "1"])
    assert built == [True]
    header, rows = read_csv(tmp_path / "port" / "port.train")
    jheader, jrows = read_csv(tmp_path / "jax" / "jax.train")
    assert header == jheader and len(rows) == len(jrows)
    modes = [r[6:8] for r in rows]
    assert modes == [r[6:8] for r in jrows]
    assert modes.count(["train", "batch"]) >= 2
    got = np.array([r[:6] for r in rows], float)
    assert np.isfinite(got).all() and (got[:, :3] > 0).all()
    np.testing.assert_allclose(got, np.array([r[:6] for r in jrows], float),
                               rtol=2e-5, atol=1e-6)
