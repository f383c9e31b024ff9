"""The port's device-resident data path against collate and the JAX store.

* the gathered batch equals ``collate(...).to(device)`` bit for bit (all six
  fields with their dtypes) and the JAX ``DeviceStore``'s gather on the same
  split, on synthetic chains with NaN angles and missing atoms, on the real
  chains of ``examples/dev_data``, with chains longer than ``max_seq_len``,
  dead rows and several buckets;
* ``plan_batch``, ``store_nbytes`` and ``auto_enabled`` against the JAX
  functions over a table of modes and budgets;
* ``LazyBatch`` gathers on first access only, and once;
* two epochs of ``Trainer.train`` with the store and without it (prefetched
  host batches) give the same CSV rows, metrics and structure files, bit for
  bit on the CPU, with dropout on, ``--eval_train`` and structure logging;
* a saved config without the new fields loads with their defaults;
* on a card: the stored batches equal the collated ones, the store path's
  train step makes no stream synchronisation, and prefetched host batches
  survive the reuse of pinned buffers. The machine with the card has no
  JAX: the JAX package is imported inside the tests that need it, and

    python -m pytest --noconftest -m needs_cuda tests/test_torch_device_store.py

  runs the card's cases.

The port's side of the A/B against the JAX trainer with its store is
``tests/test_torch_loop.py``'s two-epoch A/B (both packages on their default
path, the store) and, on the real chains, the CLI A/B of
``tests/test_torch_dev_data.py``.
"""
import os

import numpy as np
import pytest
import torch

from protein_transformer_tpu_torch.config import TrainConfig as TConfig
from protein_transformer_tpu_torch.data import device_store as DS
from protein_transformer_tpu_torch.data.dataset import (
    Batch, ProteinSplit, collate, load_dataset)
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.training.trainer import Trainer

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV_DATA = os.path.join(ROOT, "examples", "dev_data")
FIELDS = ("seq", "ang", "ang_mask", "crd", "crd_mask", "protein_mask")


def with_nan_angles(split: dict, seed: int = 0) -> dict:
    """A copy of a split whose angles are NaN where real chains have them
    missing: phi of the first residue, psi and omega of the last, and 5% of
    the rest at random."""
    rng = np.random.default_rng(seed)
    angs = []
    for a in split["ang"]:
        a = np.array(a, np.float32)
        a[0, 0] = a[-1, 1] = a[-1, 2] = np.nan
        a[rng.random(a.shape) < 0.05] = np.nan
        angs.append(a)
    return {**split, "ang": angs}


def synthetic_split(max_len=40):
    d = make_dataset(n_train=12, n_eval=2, min_len=8, max_len=max_len, seed=0)
    return with_nan_angles(d["train"])


def dev_split(name):
    return load_dataset(DEV_DATA)[name]


# (split source, max_seq_len, length buckets, index sets): dead rows where
# the count is no batch bucket, repeats, several buckets, cut chains
CASES = {
    "synthetic-nan": (lambda: synthetic_split(), 48, (16, 24, 32, 48),
                      ([0, 1, 2], [5], [3, 3, 7, 11, 0], list(range(12)))),
    "longer-than-max": (lambda: synthetic_split(), 20, (8, 16),
                        ([0, 4, 9], [2, 2, 2, 2, 2], [11])),
    "dev-train": (lambda: dev_split("train"), 64, (32, 48, 64),
                  ([0, 1, 2], [11, 10, 9, 8, 7], list(range(12)))),
    "dev-valid-70": (lambda: dev_split("valid-70"), 64, (64,), ([0, 1],)),
    "dev-test": (lambda: dev_split("test"), 64, (32, 64), ([1], [0, 1, 0])),
}


def bits(x) -> bytes:
    return np.ascontiguousarray(np.asarray(x)).tobytes()


@pytest.mark.parametrize("case", list(CASES))
def test_gather_equals_collate_and_the_jax_gather(case):
    from protein_transformer_tpu.data import dataset as jdataset
    from protein_transformer_tpu.data import device_store as jstore
    make, max_len, buckets, index_sets = CASES[case]
    raw = make()
    split = ProteinSplit(raw["seq"], raw["ang"], raw["crd"],
                         max_seq_len=max_len)
    jsplit = jdataset.ProteinSplit(raw["seq"], raw["ang"], raw["crd"],
                                   max_seq_len=max_len)
    store = DS.DeviceStore(split, CPU)
    theirs = jstore.DeviceStore(jsplit)
    assert store.device_nbytes() == theirs.device_nbytes()
    assert store.store["seq"].dtype == torch.int32
    assert store.store["seq"].shape[0] == int(
        np.minimum(split.lens, max_len).sum())
    for idx in map(np.array, index_sets):
        plan = DS.plan_batch(split, idx, buckets, max_len)
        got = store.batch(plan)
        want = collate(split, idx, buckets, max_len).to(CPU)
        jgot = theirs.batch(jstore.plan_batch(jsplit, idx, buckets, max_len))
        assert got.n_res == want.n_res == jgot.n_res
        for f in FIELDS:
            g, w, j = getattr(got, f), getattr(want, f), getattr(jgot, f)
            assert g.dtype == w.dtype and g.shape == w.shape, (case, f)
            assert bits(g) == bits(w), (case, idx, f)
            assert bits(g) == bits(np.asarray(j).astype(
                w.numpy().dtype)), (case, idx, f)
        real = got.seq != DS.VOCAB.pad_id
        if case.startswith("dev") or case == "synthetic-nan":
            # the masks carry the NaN angles and the missing atoms
            assert not got.ang_mask[real].all()
            assert not got.crd_mask[real].all()
        if plan.n_real < len(plan.idx_padded):  # a dead row: fully masked
            dead = ~got.protein_mask
            assert (got.seq[dead] == DS.VOCAB.pad_id).all()
            assert not got.ang_mask[dead].any()
            assert not got.crd_mask[dead].any()


def test_plan_batch_store_nbytes_and_auto_enabled_match_jax():
    from protein_transformer_tpu.config import TrainConfig as JConfig
    from protein_transformer_tpu.data import dataset as jdataset
    from protein_transformer_tpu.data import device_store as jstore
    # ~7,000 residues, ~2.4 MB of store: the budgets below fall on both
    # sides of one, two and three splits' footprints
    raw = make_dataset(n_train=100, n_eval=1, min_len=60, max_len=80,
                       seed=4)["train"]
    dev = load_dataset(DEV_DATA)
    ours = [ProteinSplit(raw["seq"], raw["ang"], raw["crd"], max_seq_len=64),
            *(ProteinSplit(dev[s]["seq"], dev[s]["ang"], dev[s]["crd"],
                           max_seq_len=64) for s in ("train", "test"))]
    theirs = [jdataset.ProteinSplit(raw["seq"], raw["ang"], raw["crd"],
                                    max_seq_len=64),
              *(jdataset.ProteinSplit(dev[s]["seq"], dev[s]["ang"],
                                      dev[s]["crd"], max_seq_len=64)
                for s in ("train", "test"))]
    for o, t in zip(ours, theirs):
        assert DS.store_nbytes(o) == jstore.store_nbytes(t) > 0
        for idx in ([0], [1, 0], [0, 1, 1], list(range(len(o))) * 3,
                    list(range(len(o)))[:600]):
            got = DS.plan_batch(o, np.array(idx), (16, 32, 64), 48)
            want = jstore.plan_batch(t, np.array(idx), (16, 32, 64), 48)
            assert got.idx_padded.dtype == want.idx_padded.dtype
            assert np.array_equal(got.idx_padded, want.idx_padded)
            assert (got.lb, got.n_res, got.n_real) == (
                want.lb, want.n_res, want.n_real)
    decided = set()
    for mode in ("auto", "true", "false"):
        for budget in (0, 1, 2, 3, 4096):
            for n in (1, 2, 3):
                cfg = TConfig(device_data=mode, device_data_max_mb=budget)
                jcfg = JConfig(device_data=mode, device_data_max_mb=budget)
                got = DS.auto_enabled(cfg, ours[:n])
                assert got == jstore.auto_enabled(jcfg, theirs[:n],
                                                  n_data=1), (mode, budget, n)
                decided.add((mode, got))
    assert decided == {("auto", True), ("auto", False), ("true", True),
                       ("false", False)}
    assert DS.auto_enabled(TConfig(device_data_max_mb=2), ours[:1]) != \
        DS.auto_enabled(TConfig(device_data_max_mb=2), ours)
    assert not DS.auto_enabled(TConfig(device_data_max_mb=0), ours)
    assert DS.auto_enabled(TConfig(), ours)


def test_lazy_batch_gathers_on_first_access_only_and_once():
    raw = synthetic_split()
    split = ProteinSplit(raw["seq"], raw["ang"], raw["crd"], max_seq_len=48)
    store = DS.DeviceStore(split, CPU)
    calls = []
    gather = store.batch
    store.batch = lambda plan, **kw: (calls.append(plan),
                                      gather(plan, **kw))[1]
    plan = DS.plan_batch(split, np.array([4, 1, 7]), (48,), 48)
    lazy = DS.LazyBatch(store, plan)
    assert lazy.n_res == plan.n_res
    assert np.array_equal(lazy.protein_mask, [True] * 3 + [False])
    assert not calls
    seq = lazy.seq
    assert len(calls) == 1
    assert lazy.seq is seq
    for f in ("ang", "ang_mask", "crd", "crd_mask"):
        assert bits(getattr(lazy, f)) == bits(getattr(gather(plan), f))
    assert len(calls) == 1


LOOP = dict(model="conv-enc|5,3|1,1", d_model=32, d_ff=64, n_heads=2,
            n_layers=1, batch_size=2, loss="combined", dropout=0.1,
            optimizer="adam", lr_scheduling="noam", n_warmup_steps=10,
            epochs=2, eval_train=True, train_eval_downsample=0.5,
            log_structure_step=2, log_val_struct_step=3, cluster=True)


def synthetic_run_data():
    """Train chains with NaN angles and missing atoms, one validation split
    and test."""
    data = make_dataset(n_train=6, n_eval=2, min_len=12, max_len=30, seed=1)
    data["train"] = with_nan_angles(data["train"], seed=1)
    for split in [k for k in data if k.startswith("valid-")]:
        if split != "valid-10":
            del data[split]
    return data


DATASETS = {"synthetic-nan": synthetic_run_data,
            "dev-data": lambda: load_dataset(DEV_DATA)}


def files_under(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            with open(os.path.join(dirpath, name), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, name), root)] = \
                    f.read()
    return out


@pytest.mark.parametrize("dataset", list(DATASETS))
def test_training_with_the_store_on_and_off_is_bit_equal(dataset, tmp_path):
    data = DATASETS[dataset]()
    runs = {}
    for mode in ("true", "false"):
        cfg = TConfig(**LOOP, device_data=mode, name=f"store{mode}",
                      out_dir=str(tmp_path))
        tr = Trainer(cfg, device=CPU, data=data)
        assert tr.use_device_data == (mode == "true")
        assert (tr.train_store is not None) == (mode == "true")
        state = tr.train()
        with open(os.path.join(tr.out_dir, f"store{mode}.train")) as f:
            rows = [r.split(",")[:8] for r in f.read().splitlines()]
        runs[mode] = (tr, state, rows,
                      files_under(os.path.join(tr.out_dir, "structures")))
    (on, s_on, rows_on, files_on), (off, s_off, rows_off, files_off) = (
        runs["true"], runs["false"])
    assert on._eval_stores and not off._eval_stores
    assert s_on.step == s_off.step > 0
    # CSV rows without the time and speed columns, metrics, weights, files
    assert rows_on == rows_off and len(rows_on) > 2 * s_on.step
    for mode, m in on.metrics.items():
        if isinstance(m, dict):
            for key, value in m.items():
                if "time" in key or "speed" in key:
                    continue
                np.testing.assert_equal(value, off.metrics[mode][key],
                                        err_msg=f"{mode} {key}")
    for k, v in s_on.params.items():
        assert torch.equal(v, s_off.params[k]), k
    assert files_on == files_off and any(
        f.endswith("pred.pdb") for f in files_on)
    train = on.metrics["train"]
    for key in ("epoch-combined-full", "epoch-drmsd-full", "epoch-mse-full"):
        assert np.isfinite(train[key]) and train[key] > 0, key


def test_a_saved_config_without_the_new_fields_loads():
    """A run saved before the data path's fields existed loads with the JAX
    package's defaults for them."""
    saved = TConfig(name="old").to_dict()
    for field in ("device_data", "device_data_max_mb",
                  "automatically_determine_batch_size", "profile_dir"):
        del saved[field]
    cfg = TConfig.from_dict(saved)
    assert (cfg.device_data, cfg.device_data_max_mb,
            cfg.automatically_determine_batch_size, cfg.profile_dir) == (
        "auto", 4096, False, None)
    from protein_transformer_tpu.config import TrainConfig as JConfig
    theirs = JConfig()
    assert (cfg.device_data, cfg.device_data_max_mb,
            cfg.automatically_determine_batch_size, cfg.profile_dir) == (
        theirs.device_data, theirs.device_data_max_mb,
        theirs.automatically_determine_batch_size, theirs.profile_dir)


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_trainer(cuda, tmp_path, **kw):
    data = make_dataset(n_train=16, n_eval=4, min_len=40, max_len=64,
                        seed=2)
    cfg = TConfig(**{**LOOP, "epochs": 1, "log_structure_step": 0,
                     "log_val_struct_step": 0, "dropout": 0.1,
                     "bucket_sizes": (32, 64), "max_seq_len": 64,
                     "name": "card", "out_dir": str(tmp_path), **kw})
    return Trainer(cfg, device=cuda, data=data)


@pytest.mark.needs_cuda
def test_stored_batches_equal_the_collated_ones_on_card(cuda, tmp_path):
    tr = card_trainer(cuda, tmp_path, device_data="true")
    rng = np.random.default_rng(0)
    n = 0
    for lazy, dev in tr._device_stream(tr.dm.train, tr.train_store,
                                       tr.dm.train_index_batches(rng)):
        idx = lazy._plan.idx_padded[:lazy._plan.n_real]
        want = collate(tr.dm.train, idx, tr.cfg.bucket_sizes,
                       tr.dm.max_seq_len).to(cuda)
        for f in FIELDS:
            g, w = getattr(dev, f), getattr(want, f)
            assert g.dtype == w.dtype and g.device == w.device
            assert bits(g.cpu()) == bits(w.cpu()), f
        n += 1
    assert n > 0


@pytest.mark.needs_cuda
def test_store_path_train_epoch_never_synchronises_on_card(cuda, tmp_path):
    """A whole training epoch on the store path, the metric windows and the
    NaN watchdog included, under set_sync_debug_mode("error")."""
    tr = card_trainer(cuda, tmp_path, device_data="true")
    state = tr.init_state(torch.Generator().manual_seed(0))
    state = tr.train_epoch(state)  # builds every kernel and table once
    torch.cuda.synchronize()
    steps = state.step
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = tr.train_epoch(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step > steps
    assert np.isfinite(tr.metrics["train"]["epoch-combined-full"])


@pytest.mark.needs_cuda
def test_prefetched_host_batches_survive_pinned_buffer_reuse(cuda, tmp_path):
    """Every host batch through the prefetch thread and the copy stream,
    while the step's stream is kept busy, equals its collated copy: no
    pinned buffer is reused before its copy has landed, and no batch is
    read before its copy has."""
    tr = card_trainer(cuda, tmp_path, device_data="false", repeat_train=12)
    rng = np.random.default_rng(3)
    idx_sets = list(tr.dm.train_index_batches(rng))
    hosts = [collate(tr.dm.train, idx, tr.cfg.bucket_sizes,
                     tr.dm.max_seq_len) for idx in idx_sets]
    busy = torch.randn(4096, 4096, device=cuda)
    got = []
    for host, dev in tr._host_stream(iter(hosts)):
        for _ in range(4):  # the consumer's stream stays busy
            busy = busy @ busy / 64
        got.append((host, Batch(*(getattr(dev, f).clone() for f in FIELDS),
                                n_res=dev.n_res)))
    torch.cuda.synchronize()
    assert len(got) == len(hosts) >= 8
    for host, dev in got:
        want = host.to(cuda)
        for f in FIELDS:
            assert bits(getattr(dev, f).cpu()) == bits(
                getattr(want, f).cpu()), f
