"""The port's multi-device training (``parallel/``) against the JAX package.

* (a) the pure functions case for case: ``process_local_rows``, the mesh
  shape inference and its errors, ``param_spec`` on every flax path of the
  three model families, ``_partition_shards``, ``bucket_batch_size`` and
  ``collate`` with a batch multiple;
* real multi-process runs on the CPU with gloo, one rank a process
  (``tests/torch_parallel_worker.py``): a 2-process world and a 4-process
  world, each launched once for the module with ports and a timeout of its
  own; a timeout fails the test. Against them:
  (b) the sharded store's gather is bit-equal to ``collate``'s rows, dead
  row and cut proteins included; (c) the CLI's per-batch and per-epoch CSV
  numbers under ``--mesh_shape -1`` (2 ranks) and ``2 2`` ('data' x
  'model', 4 ranks) equal the single-process run's (the JAX multi-process
  test's tolerance, rtol 2e-4, atol 1e-6); (d) one step of 2-rank DP and of
  (1, 2) TP, from the same weights, equals the JAX package's
  single-process step on a batch of 15 real proteins in 16 rows, so that
  the ranks hold 8 and 7; (e) at dropout 0.1 under (2, 2) every parameter
  is bit-equal across the ranks that hold it after 3 steps; (f) a (1, 2)
  run's checkpoint restores in one process with its eval metrics, and the
  checkpoint policy takes rank 0's time decision; (g) the clip's norm
  under TP is the full gradients' norm.

Cost: ~45 s in one worker (the two worlds run at once, beside the
single-process run and the JAX step).
"""
import csv
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_transformer_tpu.config import TrainConfig as JConfig
from protein_transformer_tpu.data import dataset as jdataset
from protein_transformer_tpu.data import device_store as jstore
from protein_transformer_tpu.models.factory import make_model as jmake_model
from protein_transformer_tpu.parallel import distributed as jdist
from protein_transformer_tpu.parallel import mesh as jmesh
from protein_transformer_tpu.parallel import sharding as jsharding
from protein_transformer_tpu.training.trainer import (
    Trainer as JTrainer, compute_losses as jcompute_losses)
from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data import dataset as tdataset
from protein_transformer_tpu_torch.data import device_store as tstore
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.models.factory import make_model
from protein_transformer_tpu_torch.models.flax_import import (
    flax_names, flax_to_state_dict)
from protein_transformer_tpu_torch.parallel import distributed as tdist
from protein_transformer_tpu_torch.parallel import mesh as tmesh
from protein_transformer_tpu_torch.parallel import sharding as tsharding
from protein_transformer_tpu_torch.training import cli
from protein_transformer_tpu_torch.training.trainer import Trainer

import torch_parallel_worker as W
from test_torch_train import NOISE_ONLY, device_batch, flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# each world's own limit; reaching it fails the test
TIMEOUT = 180


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("n_proc", [1, 2, 4, 8])
def test_process_local_rows_disjoint_covering_and_as_jax(n_proc):
    blocks = [tdist.process_local_rows(16, p, n_proc) for p in range(n_proc)]
    assert blocks == [jdist.process_local_rows(16, p, n_proc)
                      for p in range(n_proc)]
    seen = [i for blk in blocks for i in range(16)[blk]]
    assert seen == list(range(16))


def test_process_local_rows_requires_divisibility():
    for fn in (tdist.process_local_rows, jdist.process_local_rows):
        with pytest.raises(ValueError, match="not divisible by process "
                                             "count 4"):
            fn(10, 0, 4)


MESH_CASES = {
    "infer-data": ((-1,), 4), "infer-data-of-1": ((-1,), 1),
    "infer-with-model": ((-1, 2), 8), "explicit": ((2, 2), 4),
    "infer-model": ((2, -1), 4),
    "cannot-infer": ((-1, 3), 4), "zero-axis": ((0, -1), 4),
    "too-big": ((2, 4), 4),
}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_shape_inference_and_errors_match_jax(case):
    shape, n = MESH_CASES[case]
    axes = ("data", "model")[:len(shape)]
    try:
        want = list(dict(jmesh.make_mesh(shape, axes,
                                         jax.devices()[:n]).shape).values())
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.infer_shape(shape, n)
        assert str(got.value) == str(e)
        return
    assert tmesh.infer_shape(shape, n) == want


def test_single_process_mesh_and_its_refusals():
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1} and mesh.axis("model").size == 1
    with pytest.raises(ValueError, match="needs 4 devices, only 1"):
        tmesh.make_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.make_mesh((2, 2), ("data",))


def test_initialize_is_a_noop_alone_and_needs_the_process_id(monkeypatch):
    for var in ("PTT_COORDINATOR", "PTT_NUM_PROCESSES", "PTT_PROCESS_ID",
                "PTT_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize_from_env(CPU) == (0, 1)
    monkeypatch.setenv("PTT_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("PTT_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match=r"PTT_PROCESS_ID must be set "
                                           r"\(0\.\.1\)"):
        tdist.initialize_from_env(CPU)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,local,cards,want", [
    ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"), ("cuda", 2, 4, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cpu", 2, 0, "gloo"), ("cpu", 1, 8, "gloo")])
def test_backend_follows_the_layout(device, local, cards, want):
    assert tdist.choose_backend(device, local, cards) == want


FAMILIES = {"conv-enc": "conv-enc|5,3|1,1", "enc-only": "enc-only",
            "enc-dec": "enc-dec"}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_param_spec_on_every_flax_path_matches_jax(family):
    kw = dict(model=FAMILIES[family], d_model=16, d_ff=32, n_heads=2,
              n_layers=2, max_seq_len=32)
    tmodel = make_model(TrainConfig(**kw).finalize(),
                        np.zeros(24, np.float32))
    jmodel = jmake_model(JConfig(**kw).finalize(), np.zeros(24, np.float32))
    ids = jnp.zeros((2, 8), jnp.int32)
    shapes = jax.eval_shape(
        jmodel.init, {k: jax.random.PRNGKey(0)
                      for k in ("params", "dropout", "sampling")},
        ids, jnp.zeros((2, 8, 24)))
    jpaths = {jsharding._path_str(p)[len("params/"):]: leaf.shape
              for p, leaf in jax.tree_util.tree_flatten_with_path(
                  shapes)[0]}
    ours = flax_names(tmodel)
    assert set(ours.values()) == set(jpaths)
    params = dict(tmodel.named_parameters())
    n_sharded = 0
    for name, path in ours.items():
        spec = tsharding.param_spec(path)
        assert tuple(spec) == tuple(jsharding.param_spec(path)), path
        dim = tsharding.sharded_dim(path, params[name].shape, 2)
        if "model" in spec:
            # the torch dim that holds the flax dim, reversed for kernels
            flax_dim = spec.index("model")
            assert params[name].shape[dim] == jpaths[path][flax_dim]
            n_sharded += 1
        else:
            assert dim is None
    # 7 leaves a layer with one attention block, 11 with two
    assert n_sharded == {"conv-enc": 14, "enc-only": 14,
                         "enc-dec": 36}[family]


def test_partition_shards_matches_jax():
    rng = np.random.default_rng(0)
    for n_shards in (1, 2, 3, 4, 8):
        lens = rng.integers(5, 500, size=rng.integers(1, 60))
        got = tstore._partition_shards(lens, n_shards)
        want = jstore._partition_shards(lens, n_shards)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_bucket_batch_size_and_collate_with_a_multiple_match_jax(data):
    for n in (1, 3, 7, 15, 16, 17, 33, 500, 513, 700):
        for m in (1, 2, 3, 4, 8):
            assert tdataset.bucket_batch_size(n, m) == \
                jdataset.bucket_batch_size(n, m), (n, m)
    raw = data["train"]
    ours = tdataset.ProteinSplit(raw["seq"], raw["ang"], raw["crd"],
                                 max_seq_len=24)
    theirs = jdataset.ProteinSplit(raw["seq"], raw["ang"], raw["crd"],
                                   max_seq_len=24)
    for idx, m, pad in ((np.arange(5), 4, True), (np.arange(3, 18), 2, True),
                        (np.arange(7), 8, False)):
        got = tdataset.collate(ours, idx, (16, 24), 24, pad_batch=pad,
                               batch_multiple=m)
        want = jdataset.collate(theirs, idx, (16, 24), 24, pad_batch=pad,
                                batch_multiple=m)
        for field in ("seq", "ang", "ang_mask", "crd", "crd_mask",
                      "protein_mask", "n_res"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        plan = tstore.plan_batch(ours, idx, (16, 24), 24, m)
        jplan = jstore.plan_batch(theirs, idx, (16, 24), 24, m)
        np.testing.assert_array_equal(plan.idx_padded, jplan.idx_padded)


# ------------------------------------------------------ the worlds' runs

@pytest.fixture(scope="module")
def data():
    return make_dataset(n_train=30, n_eval=4, min_len=12, max_len=32,
                        seed=0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: str, n: int, where: str) -> list:
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   PTT_COORDINATOR=f"127.0.0.1:{port}",
                   PTT_NUM_PROCESSES=str(n), PTT_PROCESS_ID=str(rank))
        env.pop("PTT_DISTRIBUTED", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "torch_parallel_worker.py"),
             world, where], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def finish(procs: list, what: str) -> list:
    """The outputs of a world's processes; a timeout or a failing rank
    fails the test."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{what} did not finish within {TIMEOUT} s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{what} rank {rank}:\n{out[-4000:]}"
        assert "backend gloo" in out and f"done rank {rank}" in out
    return outs


def port_step(trainer, params, batch):
    state = trainer.state_from(params)
    loss, _, grads = trainer.loss_and_grads(state.params, batch.to(CPU))
    return float(loss.detach()), dict(zip(state.params, grads))


@pytest.fixture(scope="module")
def worlds(data, tmp_path_factory):
    """Both worlds run at once; meanwhile this process runs the CLI on one
    process, and the JAX package's and the port's single-process step."""
    where = str(tmp_path_factory.mktemp("worlds"))
    torch.save(data, os.path.join(where, "data.pt"))
    jtr = JTrainer(JConfig(**W.SMALL, out_dir=where, name="jax"), data=data,
                   use_mesh=False)
    jbatch = jdataset.collate(jtr.dm.train, np.arange(15),
                              jtr.cfg.bucket_sizes, jtr.dm.max_seq_len)
    assert jbatch.seq.shape[0] == 16 and jbatch.protein_mask.sum() == 15
    fparams = flax_params(jtr, jbatch)
    tr = Trainer(TrainConfig(**W.SMALL, out_dir=where, name="one"), CPU,
                 data=data)
    params = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, fparams),
                                tr.model)
    torch.save(params, os.path.join(where, "params.pt"))

    procs2 = launch("world2", 2, where)
    procs4 = launch("world4", 4, where)
    one = os.path.join(where, "one")
    one_logged = W.run_cli(["--data", os.path.join(where, "data.pt"),
                            "--name", "dist", "--out_dir", one,
                            *W.CLI_ARGS])
    dev = device_batch(jbatch)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jcompute_losses(jtr.model, p, dev, jtr.cfg)[0]))(fparams)
    batch = tdataset.collate(tr.dm.train, np.arange(15), tr.cfg.bucket_sizes,
                             tr.dm.max_seq_len)
    port_loss, port_grads = port_step(tr, params, batch)
    enc_dec = Trainer(TrainConfig(**{**W.SMALL, "model": "enc-dec"},
                                  out_dir=where, name="enc-dec"), CPU,
                      data=data)
    enc_dec_step = port_step(
        enc_dec, enc_dec.init_params(torch.Generator().manual_seed(5)),
        batch)
    logs = {"world2": finish(procs2, "the 2-process world"),
            "world4": finish(procs4, "the 4-process world")}

    def load(scenario, rank=0):
        return torch.load(os.path.join(where, f"{scenario}.rank{rank}.pt"),
                          weights_only=False)

    return dict(where=where, load=load, logs=logs, one=one, tr=tr,
                params=params, jloss=float(loss),
                jgrads=flax_to_state_dict(
                    jax.tree_util.tree_map(np.asarray, grads), tr.model),
                port_loss=port_loss, port_grads=port_grads,
                enc_dec_step=enc_dec_step, one_logged=one_logged)


# ------------------------------------------------------------------ (b)

@pytest.mark.parametrize("case", ["dead_row", "cut"])
def test_sharded_gather_is_bit_equal_to_collate(worlds, data, case):
    raw = data["train"]
    split = tdataset.ProteinSplit(raw["seq"], raw["ang"], raw["crd"],
                                  max_seq_len=W.CUT)
    got = [worlds["load"]("gather", r)[case] for r in (0, 1)]
    want = tdataset.collate(split, got[0]["idx"], (16, W.CUT), W.CUT,
                            batch_multiple=2).to(CPU)
    n = want.seq.shape[0]
    if case == "dead_row":
        assert n == 16 and not want.protein_mask[-1]
    else:
        assert max(split.lens) == W.CUT and len(raw["seq"][
            int(got[0]["idx"][0])]) > W.CUT
    for field in ("seq", "ang", "ang_mask", "crd", "crd_mask",
                  "protein_mask"):
        full = getattr(want, field)
        for rank, g in enumerate(got):
            rows = getattr(g["rows"], field)
            half = full[rank * n // 2:(rank + 1) * n // 2]
            for mine, theirs in ((rows, half),
                                 (getattr(g["whole"], field), full)):
                assert mine.dtype == theirs.dtype, field
                assert torch.equal(mine.view(torch.uint8),
                                   theirs.view(torch.uint8)), field


# ------------------------------------------------------------------ (c)

def files_under(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, names in os.walk(path) for f in names)


def csv_numbers(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    keys = ("drmsd", "ln_drmsd", "rmse", "rmsd", "combined")
    return ([(r["mode"], r["granularity"]) for r in rows],
            np.array([[float(r[k]) for k in keys] for r in rows]))


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_multi_process_cli_run_matches_single_process(worlds, world):
    labels, numbers = csv_numbers(os.path.join(worlds["where"], world,
                                               "dist", "dist.train"))
    want_labels, want = csv_numbers(os.path.join(worlds["one"], "dist",
                                                 "dist.train"))
    assert labels == want_labels
    assert labels.count(("train", "batch")) == 4
    np.testing.assert_allclose(numbers, want, rtol=2e-4, atol=1e-6)
    # rank 0 alone wrote the sinks, as the single process did
    run_dir = os.path.join(worlds["where"], world, "dist")
    assert os.path.exists(os.path.join(run_dir, "config.json"))
    assert files_under(os.path.join(run_dir, "structures")) == \
        files_under(os.path.join(worlds["one"], "dist", "structures"))
    want = worlds["one_logged"]
    got = worlds["load"](f"wandb_{world}")
    assert got["keys"] == want["keys"] and got["totals"] == want["totals"]
    np.testing.assert_allclose(got["rmse"], want["rmse"], rtol=2e-4,
                               atol=1e-6)
    assert all(worlds["load"](f"wandb_{world}", r) == {}
               for r in range(1, 2 if world == "world2" else 4))
    if world == "world4":
        assert worlds["load"]("replicas")["layout"], "nothing is sharded"


# ------------------------------------------------------------------ (d)

@pytest.mark.parametrize("tag", ["step_dp", "step_tp"])
def test_one_step_with_unequal_rank_counts_matches_jax(worlds, tag):
    """The tolerance of tests/test_torch_train.py's one-step A/B: loss
    within 1e-5 relative, each gradient within 1e-3 of its largest JAX
    entry, the key biases (exact gradient 0) within 1e-6 of the model's
    largest."""
    got = [worlds["load"](tag, r) for r in (0, 1)]
    assert [g["real_rows"] for g in got] == (
        [8, 7] if tag == "step_dp" else [15, 15])
    if tag == "step_tp":
        assert got[0]["layout"]
    jloss, jgrads = worlds["jloss"], worlds["jgrads"]
    top = max(float(g.abs().max()) for g in jgrads.values())
    for g in got:
        assert abs(g["loss"] - jloss) <= 1e-5 * abs(jloss)
        assert set(g["grads"]) == set(jgrads)
        for name, grad in g["grads"].items():
            want = jgrads[name]
            scale = (1e-3 * top if name.endswith(NOISE_ONLY)
                     else float(want.abs().max()))
            assert float((grad - want).abs().max()) <= 1e-3 * scale, name


@pytest.mark.parametrize("tag", ["step_enc_dec_dp", "step_enc_dec_tp"])
def test_enc_dec_step_matches_the_single_process_port(worlds, tag):
    """The encoder-decoder under DP and under TP (the decoder's causal
    self-attention and its cross-attention on the encoder output split over
    'model' too) against the port's single-process step from the same
    seeded weights: loss within 1e-5 relative, each gradient within 1e-4 of
    its largest entry, the key biases within 1e-6 of the model's largest."""
    loss, grads = worlds["enc_dec_step"]
    top = max(float(g.abs().max()) for g in grads.values())
    for rank in (0, 1):
        got = worlds["load"](tag, rank)
        assert (tag == "step_enc_dec_tp") == bool(got["layout"])
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
        for name, grad in got["grads"].items():
            want = grads[name]
            scale = (1e-2 * top if name.endswith(NOISE_ONLY)
                     else float(want.abs().max()))
            assert float((grad - want).abs().max()) <= 1e-4 * scale, name


# ------------------------------------------------------------------ (e)

def test_replicated_parameters_stay_bit_equal_at_dropout(worlds):
    got = [worlds["load"]("replicas", r) for r in range(4)]
    assert [g["coords"] for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    layout = got[0]["layout"]
    assert layout
    for name, p0 in got[0]["params"].items():
        for g in got[1:]:
            same_slice = name not in layout or g["coords"][1] == 0
            equal = torch.equal(g["params"][name], p0)
            assert equal == same_slice, (name, g["coords"])


# ------------------------------------------------------------------ (f)

def test_tp_checkpoint_restores_in_one_process(worlds, data):
    tp = worlds["load"]("tp_run")
    # both ranks read the same metrics (their clocks apart)
    other = worlds["load"]("tp_run", 1)
    for split, m in tp.items():
        assert {k: v for k, v in m.items() if k.endswith("-full")} == {
            k: v for k, v in other[split].items() if k.endswith("-full")}
    tr = Trainer(TrainConfig(**W.SMALL, out_dir=worlds["where"], name="tp",
                             epochs=1), CPU, data=data)
    state = tr.maybe_restore(tr.init_state(torch.Generator().manual_seed(9)))
    assert tr.start_epoch == 1 and state.step == 2
    for split in ("valid-10", "valid-90"):
        got = tr.eval_epoch(state.params, split)
        for key in ("epoch-drmsd-full", "epoch-mse-full", "epoch-rmsd-full",
                    "epoch-combined-full"):
            np.testing.assert_allclose(got[key], tp[split][key], rtol=2e-4,
                                       atol=1e-6)


def test_checkpoint_policy_takes_rank_0s_time_decision(worlds):
    assert [worlds["load"]("policy", r) for r in (0, 1)] == ["latest"] * 2


# ------------------------------------------------------------------ (g)

def test_clip_norm_under_tp_is_the_full_norm(worlds):
    want = float(torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in worlds["port_grads"].values()])))
    for rank in (0, 1):
        got = worlds["load"]("step_tp", rank)
        np.testing.assert_allclose(got["clip_norm"], got["full_norm"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["clip_norm"], want, rtol=1e-5)
    assert abs(worlds["port_loss"] - worlds["jloss"]) <= \
        1e-5 * abs(worlds["jloss"])
