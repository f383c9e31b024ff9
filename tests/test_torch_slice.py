"""The port's eval slice as a whole against the JAX package's trainer.

sequence -> conv-enc model -> sin/cos -> NeRF -> dRMSD / MSE / RMSD, with
the same data (one synthetic dataset) and the same weights (the JAX
trainer's params through the weights bridge). Gates: mse <= 1e-5; drmsd,
ln-drmsd, combined and rmsd <= 1e-3.
"""
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from protein_transformer_tpu.config import TrainConfig as JConfig
from protein_transformer_tpu.data import synthetic as jsyn
from protein_transformer_tpu.data.dataset import collate as jcollate
from protein_transformer_tpu.training.trainer import Trainer as JTrainer
from protein_transformer_tpu_torch.config import TrainConfig as TConfig
from protein_transformer_tpu_torch.data import synthetic as tsyn
from protein_transformer_tpu_torch.data.dataset import collate
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.models.flax_import import flax_to_state_dict
from protein_transformer_tpu_torch.training.trainer import (
    METRIC_KEYS, Trainer as TTrainer, unpack_metrics)

CPU = torch.device("cpu")
SPLIT = "valid-70"
CONFIG = dict(model="conv-enc|5,3|1,1", d_model=32, d_ff=64, n_heads=2,
              n_layers=2, batch_size=4, loss="combined", dropout=0.1,
              bucket_sizes=(48,), max_seq_len=48)
GATES = {"mse-full": 1e-5, "mse-bb": 1e-5, "mse-sc": 1e-5}


def gate(key):
    return GATES.get(key, 1e-3)


@pytest.fixture(scope="module")
def data():
    return jsyn.make_dataset(n_train=8, n_eval=8, min_len=30, max_len=44,
                             seed=0)


@pytest.fixture(scope="module")
def pair(data, tmp_path_factory):
    """(JAX trainer, its params, port trainer, bridged params)."""
    out = tmp_path_factory.mktemp("jax_run")
    jtr = JTrainer(JConfig(**CONFIG, out_dir=str(out), name="slice"),
                   data=data, use_mesh=False)
    params = jax.tree_util.tree_map(np.asarray, jtr.init_state().params)
    # a random output head, so the trunk reaches the outputs
    head = params["params"]["AngleProjection_0"]["output_projection"]
    head["kernel"] = np.random.default_rng(0).normal(
        0, 0.3, head["kernel"].shape).astype(np.float32)
    ttr = TTrainer(TConfig(**CONFIG), device=CPU, data=data)
    tparams = flax_to_state_dict(params, ttr.model)
    return jtr, params, ttr, tparams


def test_eval_step_matches_jax(pair):
    jtr, params, ttr, tparams = pair
    idx = next(ttr.dm.eval_index_batches(SPLIT))
    np.testing.assert_array_equal(idx, next(jtr.dm.eval_index_batches(SPLIT)))
    batch = collate(ttr.dm.eval_splits[SPLIT], idx, ttr.cfg.bucket_sizes,
                    ttr.dm.max_seq_len)
    jbatch = jcollate(jtr.dm.eval_splits[SPLIT], idx, jtr.cfg.bucket_sizes,
                      jtr.dm.max_seq_len)
    assert batch.seq.shape == (4, 44)  # bucket 48 clamped to max_len
    for field in ("seq", "ang", "ang_mask", "crd", "crd_mask",
                  "protein_mask", "n_res"):
        np.testing.assert_array_equal(getattr(batch, field),
                                      getattr(jbatch, field))
    step = jtr._jit_cache.setdefault("eval", jtr._eval_step_fn())
    want = unpack_metrics(np.asarray(step(params, jbatch)))
    got = unpack_metrics(ttr.eval_step(tparams, batch).numpy())
    assert set(got) == set(METRIC_KEYS)
    for key in METRIC_KEYS:
        assert np.isfinite(got[key]), key
        assert abs(got[key] - want[key]) <= gate(key), (key, got[key],
                                                       want[key])
    assert got["drmsd-full"] > 0 and got["rmsd-full"] > 0


def test_eval_epoch_matches_jax(pair):
    jtr, params, ttr, tparams = pair
    jtr._jit_cache.setdefault("eval", jtr._eval_step_fn())
    jtr.eval_epoch(params, SPLIT, jtr.dm.eval_batches(SPLIT), None)
    want = jtr.metrics[SPLIT]
    got = ttr.eval_epoch(tparams, SPLIT)
    assert got is ttr.metrics[SPLIT]
    for key in ("drmsd-full", "lndrmsd-full", "mse-full", "combined-full",
                "rmsd-full", "drmsd-bb", "lndrmsd-bb", "mse-bb", "mse-sc"):
        assert abs(got[f"epoch-{key}"] - want[f"epoch-{key}"]) \
            <= gate(key), key
    assert got["epoch-history-drmsd"] == [got["epoch-drmsd-full"]]


def test_init_params_follow_flax_init(pair):
    _, params, ttr, tparams = pair
    fresh = ttr.init_params(torch.Generator().manual_seed(0))
    assert set(fresh) == set(tparams)
    for name, p in fresh.items():
        assert p.shape == tparams[name].shape and p.device == CPU
    assert (fresh["head.output_projection.weight"] == 0).all()
    assert torch.equal(fresh["head.output_projection.bias"],
                       torch.tensor(params["params"]["AngleProjection_0"]
                                    ["output_projection"]["bias"]))
    assert (fresh["layers.0.sublayer.0.norm.weight"] == 1).all()
    w = fresh["layers.0.attn.wq.weight"]
    bound = np.sqrt(6 / (w.shape[0] + w.shape[1]))
    assert float(w.abs().max()) <= bound and float(w.std()) > bound / 3
    again = ttr.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(fresh[k], again[k]) for k in fresh)


def test_make_dataset_matches_jax():
    """One seed, the same draws: sequences, angles and the missing-atom
    pattern are identical; coordinates come from each package's own NeRF
    build and agree to the 1e-3 A gate."""
    kw = dict(n_train=3, n_eval=2, min_len=10, max_len=30, seed=7)
    want = jsyn.make_dataset(**kw)
    got = tsyn.make_dataset(**kw)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["settings"]["angle_means"],
                                  want["settings"]["angle_means"])
    for split in [k for k in want if isinstance(want[k], dict)
                  and "seq" in want[k]]:
        assert got[split]["seq"] == want[split]["seq"]
        assert got[split]["ids"] == want[split]["ids"]
        for ga, wa in zip(got[split]["ang"], want[split]["ang"]):
            np.testing.assert_array_equal(ga, wa)
        for gc, wc in zip(got[split]["crd"], want[split]["crd"]):
            np.testing.assert_array_equal(np.isnan(gc), np.isnan(wc))
            assert np.nanmax(np.abs(gc - wc)) <= 1e-3


def test_cuda_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_device()


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import protein_transformer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in ('jax', 'flax') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 15
