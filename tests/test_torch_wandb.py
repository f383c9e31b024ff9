"""The port's wandb logging against the JAX package's.

A recording fake stands in for the ``wandb`` package (neither machine has
it). Each of the twelve functions of ``training/wandb_logging.py`` logs the
payloads and summaries of the JAX module's function on the same inputs, key
for key and value for value (histograms by their edges and counts); the
parameter and gradient histograms of weights carried across from flax keep
JAX's names and bins; ``Trainer._probe_gradients`` picks the JAX trainer's
rows and its gradients agree with JAX's within the train step's gate, 1e-3
of each parameter's largest entry, at dropout 0; a two-epoch CLI run logs
the keys and summaries that JAX's module functions give for that run, which
is the list ``chip_smoke.py`` phase 17 checks on the card; the structure
logger's wandb branch logs JAX's payload. The port side runs on the CPU.

Cost: ~15 s in one worker, most of it the JAX probe's compile.
"""
import csv
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import chip_smoke
from protein_transformer_tpu import config as jconfig
from protein_transformer_tpu.data import dataset as jdataset
from protein_transformer_tpu.models.factory import make_model as jmake_model
from protein_transformer_tpu.training import structure_logging as jsl
from protein_transformer_tpu.training import wandb_logging as JW
from protein_transformer_tpu.training.trainer import (
    Trainer as JTrainer, TrainState as JTrainState)
from protein_transformer_tpu_torch.config import TrainConfig as TConfig
from protein_transformer_tpu_torch.data import device_store as DS
from protein_transformer_tpu_torch.data import synthetic as tsyn
from protein_transformer_tpu_torch.data.dataset import collate
from protein_transformer_tpu_torch.models.factory import (
    make_model, model_args)
from protein_transformer_tpu_torch.models.flax_import import (
    flax_names, flax_to_state_dict, load_flax_params, to_flax_layout)
from protein_transformer_tpu_torch.training import cli as tcli
from protein_transformer_tpu_torch.training import metrics as M
from protein_transformer_tpu_torch.training import structure_logging as tsl
from protein_transformer_tpu_torch.training import trainer as ttrainer
from protein_transformer_tpu_torch.training import wandb_logging as TW
from protein_transformer_tpu_torch.training.trainer import Trainer

from test_observability import _random_structure
from test_torch_train import NOISE_ONLY, SLICE, flax_params

CPU = torch.device("cpu")


class Recorded:
    """A fake wandb object (Histogram, Molecule, Object3D, Image): keeps
    what it was given; a file handed to it is read at once, as wandb does."""

    def __init__(self, data=None, np_histogram=None, **kw):
        if hasattr(data, "read"):
            data = ("file", os.path.basename(data.name), data.read())
        self.data, self.np_histogram, self.kw = data, np_histogram, kw

    def key(self):
        """What two objects must share to be the same log entry."""
        if self.np_histogram is not None:
            counts, edges = self.np_histogram
            return ("histogram", tuple(counts.tolist()),
                    tuple(edges.tolist()))
        return (type(self).__name__, self.data, tuple(sorted(self.kw)))


class FakeRun:
    """Records summary writes, log payloads (with their commit flag),
    save() calls, config updates and finish()."""

    def __init__(self, **init):
        self.init = init
        self.summary = {}
        self.logged = []
        self.saved = []
        self.updates = []
        self.finished = False
        self.config = types.SimpleNamespace(
            update=lambda d, **kw: self.updates.append((d, kw)))

    def log(self, payload, commit=True):
        self.logged.append((payload, commit))

    def save(self, path, base_path=None, policy=None):
        self.saved.append((path, base_path, policy))

    def finish(self):
        self.finished = True

    def keys(self):
        return {k for payload, _ in self.logged for k in payload}


@pytest.fixture
def fake_wandb(monkeypatch):
    """A recording ``wandb`` module; ``fake.runs`` collects the runs its
    ``init`` made."""
    fake = types.ModuleType("wandb")
    fake.runs = []

    def init(**kw):
        fake.runs.append(FakeRun(**kw))
        return fake.runs[-1]

    fake.init = init
    for name in ("Histogram", "Molecule", "Object3D", "Image"):
        setattr(fake, name, type(name, (Recorded,), {}))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    return fake


def comparable(value):
    if isinstance(value, Recorded):
        return value.key()
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    return value


def same_run(ours: FakeRun, theirs: FakeRun) -> None:
    """Payloads (in order, with their commit flags), summaries and saves
    equal, key for key and value for value."""
    assert len(ours.logged) == len(theirs.logged)
    for (a, ca), (b, cb) in zip(ours.logged, theirs.logged):
        assert ca == cb
        assert list(a) == list(b)
        for k in a:
            assert comparable(a[k]) == comparable(b[k]), k
    assert {k: comparable(v) for k, v in ours.summary.items()} == {
        k: comparable(v) for k, v in theirs.summary.items()}
    assert ours.saved == theirs.saved


def epoch_metrics(seed=0):
    """A metrics dict after an epoch of train and two validation splits,
    with distinct values per key."""
    rng = np.random.default_rng(seed)
    modes = ["train", "valid-10", "valid-90", "test"]
    metrics = M.init_metrics(modes)
    for mode in modes:
        metrics = M.reset_for_epoch(metrics, mode)
        for _ in range(2):
            losses = {k: float(rng.uniform(0.5, 3.0)) for k in M.LOSS_KEYS}
            metrics = M.update_batch(metrics, mode, losses,
                                     int(rng.integers(50, 500)))
        metrics = M.end_of_epoch(metrics, mode)
    return metrics


def call_both(name, *args, **kw):
    """The fake runs after calling ``name`` of both modules with ``args``."""
    ours, theirs = FakeRun(), FakeRun()
    getattr(TW, name)(ours, *args, **kw)
    getattr(JW, name)(theirs, *args, **kw)
    return ours, theirs


METRICS = epoch_metrics()
ROW = {k: float(v) for k, v in zip(
    M.LOSS_KEYS, np.random.default_rng(1).uniform(0.1, 2.0,
                                                  len(M.LOSS_KEYS)))}
CASES = {
    "log_checkpoint_summary": ("best", 1.25, 3, METRICS, False),
    "log_checkpoint_summary-train_only": ("latest", 2.5, 4, METRICS, True),
    "log_final_epoch_summary": ("valid-90", METRICS["valid-90"]),
    "log_early_stop": (),
    "log_train_batch": (ROW, 15, 1234.5),
    "log_eval_epoch": ("valid-10", METRICS["valid-10"]),
    "log_avg_validation": (METRICS, ["valid-10", "valid-90"]),
    "log_avg_validation-none": (METRICS, []),
}


@pytest.mark.parametrize("case", list(CASES))
def test_logging_functions_match_jax(case, fake_wandb):
    name = case.split("-")[0]
    kw = {"lr": 3e-4} if name == "log_train_batch" else {}
    ours, theirs = call_both(name, *CASES[case], **kw)
    same_run(ours, theirs)
    assert ours.logged or ours.summary or case.endswith("none")
    # every function is a no-op without a run
    getattr(TW, name)(None, *CASES[case])


def test_angle_histograms_match_jax(fake_wandb):
    rng = np.random.default_rng(2)
    pred = rng.uniform(-1, 1, (3, 9, 24)).astype(np.float32)
    seq = rng.integers(0, 20, (3, 9))
    seq[1, 6:] = seq[2, :] = 20
    ours, theirs = call_both("log_angle_histograms", pred, seq, 20)
    same_run(ours, theirs)
    (payload, commit), = ours.logged
    assert not commit and set(payload) == set(
        chip_smoke.WANDB_ANGLE_HISTOGRAMS)
    counts, _ = payload["Predicted Angles (sin cos)"].np_histogram
    assert counts.sum() == (9 + 6) * 24  # the real residues of rows 0, 1


def test_init_model_txt_mirroring_and_missing_package(fake_wandb, tmp_path,
                                                      capsys, monkeypatch):
    kw = dict(name="w", batch_size=5, max_seq_len=64, use_wandb=True)
    ours = TW.try_init_wandb(TConfig(**kw).finalize(), 1234, None)
    theirs = JW.try_init_wandb(jconfig.TrainConfig(**kw).finalize(), 1234,
                               None)
    assert ours.init["project"] == theirs.init["project"] == \
        "protein-transformer-tpu"
    assert ours.init["name"] == theirs.init["name"] == "w"
    # the config payload is the run's own config; the fields the packages
    # share hold the same values
    shared = set(ours.init["config"]) & set(theirs.init["config"])
    assert len(shared) > 50
    assert {k: ours.init["config"][k] for k in shared} == {
        k: theirs.init["config"][k] for k in shared}
    assert ours.updates == theirs.updates == [
        ({"n_params": 1234, "max_seq_len": 64}, {"allow_val_change": True})]
    assert ours.summary == theirs.summary == {
        "stopped_training_early": False, "max_batch_size": 5}
    assert TW.try_init_wandb(TConfig().finalize(), 1, None) is None

    for mod, sub in ((TW, "t"), (JW, "j")):
        out = tmp_path / sub
        out.mkdir()
        run = FakeRun()
        mod.save_model_txt(run, "MODEL", str(out))
        mod.mirror_run_files(run, str(out))
        assert (out / "MODEL.txt").read_text() == "MODEL\n"
        assert [os.path.relpath(p, out) for p, _, _ in run.saved] == [
            "MODEL.txt", "checkpoints/*", "structures/*", "*.train"]
        assert [(b, pol) for _, b, pol in run.saved] == [
            (str(out), None)] + [(str(out), "live")] * 3
    TW.mirror_run_files(None, str(tmp_path))

    monkeypatch.setitem(sys.modules, "wandb", None)  # import fails
    assert TW.try_init_wandb(TConfig(use_wandb=True).finalize(), 1,
                             None) is None
    assert capsys.readouterr().out == \
        "[wandb] not installed; disabling wandb logging\n"


# ------------------------------------------------------- the histograms

MODELS = {"conv-enc": "conv-enc|5,3|1,1", "enc-only": "enc-only",
          "enc-dec": "enc-dec"}


def flax_tree(model_name, seed=0):
    """Random weights in the tree of the JAX model ``model_name``."""
    cfg = jconfig.TrainConfig(**{**SLICE, "model": model_name}).finalize()
    model = jmake_model(cfg, np.zeros(24, np.float32))
    batch = types.SimpleNamespace(seq=np.zeros((2, 16), np.int32),
                                  ang=np.zeros((2, 16, 24), np.float32))
    return flax_params(types.SimpleNamespace(model=model), batch, seed=seed)


@pytest.mark.parametrize("family", list(MODELS))
def test_watch_params_matches_jax_on_carried_weights(family, fake_wandb):
    """The port's parameters and gradients carried across from flax give
    JAX's histogram names, in JAX's order, and JAX's bins and counts."""
    params, grads = flax_tree(MODELS[family]), flax_tree(MODELS[family], 1)
    tcfg = TConfig(**{**SLICE, "model": MODELS[family]}).finalize()
    model = load_flax_params(make_model(tcfg, np.zeros(24)), params)
    ours = dict(model.named_parameters())
    our_grads = flax_to_state_dict(grads, model)
    run_t, run_j = FakeRun(), FakeRun()
    TW.watch_params(run_t, model, ours, grads=our_grads)
    JW.watch_params(run_j, params, grads=grads)
    same_run(run_t, run_j)
    (payload, commit), = run_t.logged
    assert not commit and len(payload) == 2 * len(ours)
    # the inverse of the bridge: flax paths and layouts
    names = flax_names(model)
    for name, path in names.items():
        node = params["params"]
        for seg in path.split("/"):
            node = node[seg]
        np.testing.assert_array_equal(
            to_flax_layout(ours[name].detach().numpy(), path), node)
    TW.watch_params(run_t, model, ours)  # parameters only
    assert all(k.startswith("parameters/") for k in run_t.logged[-1][0])


def test_histograms_of_values_a_few_ulps_apart(fake_wandb, monkeypatch):
    """Where numpy (>= 2.1) cannot make 10 float32 bins, as for a LayerNorm
    scale a few warm-up steps from 1.0, the JAX module raises; the port
    bins those values in float64. The numpy here makes such bins, so one
    that raises there stands in for it."""
    histogram = np.histogram

    def newer_numpy(a, *args, **kw):
        a = np.asarray(a)
        if a.dtype == np.float32 and np.ptp(a) < 1e-6 * np.abs(a).max():
            raise ValueError("Too many bins for data range. Cannot create "
                             "10 finite-sized bins.")
        return histogram(a, *args, **kw)

    monkeypatch.setattr(np, "histogram", newer_numpy)
    model = torch.nn.Module()
    model.norm = torch.nn.LayerNorm(4)  # flax's LayerNorm_0
    scale = 1 + torch.arange(4) * 1.2e-7
    params = {"norm.weight": scale, "norm.bias": torch.zeros(4)}
    with pytest.raises(ValueError, match="Too many bins"):
        JW.watch_params(FakeRun(), {"params": {"LayerNorm_0": {
            "scale": scale.numpy(), "bias": np.zeros(4, np.float32)}}})
    run = FakeRun()
    TW.watch_params(run, model, params)
    counts, edges = run.logged[0][0][
        "parameters/params/LayerNorm_0/scale"].np_histogram
    want = histogram(scale.numpy().astype(np.float64))
    np.testing.assert_array_equal(counts, want[0])
    np.testing.assert_array_equal(edges, want[1])


# ---------------------------------------------------- the gradient probe

@pytest.fixture(scope="module")
def data():
    return tsyn.make_dataset(n_train=8, n_eval=2, min_len=30, max_len=44,
                             seed=0)


def test_probe_gradients_match_jax(data, tmp_path, monkeypatch):
    """Dropout 0: the same rows as the JAX trainer's probe, and gradients
    within the train step's gate: 1e-3 of each parameter's largest entry,
    the key biases (an exact gradient of zero, fp32 noise in both) 1e-6 of
    the model's largest. The probe leaves the trainer's generators where
    they were."""
    step = 3
    jtr = JTrainer(jconfig.TrainConfig(**SLICE, name="j",
                                       out_dir=str(tmp_path)),
                   data=data, use_mesh=False)
    jbatch = jdataset.collate(jtr.dm.train, np.arange(4),
                              jtr.cfg.bucket_sizes, jtr.dm.max_seq_len)
    params = flax_params(jtr, jbatch)
    rows = {}

    def recording(pkg, fn):
        def collate_rows(split, idx, *a, **kw):
            rows[pkg] = np.asarray(idx)
            return fn(split, idx, *a, **kw)
        return collate_rows

    monkeypatch.setattr(jdataset, "collate",
                        recording("jax", jdataset.collate))
    monkeypatch.setattr(ttrainer, "collate",
                        recording("port", ttrainer.collate))
    want = jtr._probe_gradients(JTrainState(
        params, jtr.tx.init(params), jnp.asarray(step, jnp.int32)))

    tr = Trainer(TConfig(**SLICE, name="t", out_dir=str(tmp_path)),
                 device=CPU, data=data)
    state = tr.state_from(flax_to_state_dict(params, tr.model))
    state.step = step
    gens = [g.get_state() for g in (tr.dropout_generator,
                                    tr.sampling_generator)]
    got = tr._probe_gradients(state)
    assert all(torch.equal(a, g.get_state()) for a, g in zip(
        gens, (tr.dropout_generator, tr.sampling_generator)))
    np.testing.assert_array_equal(rows["port"], rows["jax"])
    assert len(rows["port"]) == min(SLICE["batch_size"], len(tr.dm.train))
    want = flax_to_state_dict(want, tr.model)
    assert list(got) == list(state.params)
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in got.items():
        scale = (1e-3 * top if name.endswith(NOISE_ONLY)
                 else float(want[name].abs().max()))
        assert torch.isfinite(g).all() and scale > 0, name
        assert float((g - want[name]).abs().max()) <= 1e-3 * scale, name


# --------------------------------------------- the train loop and the CLI

def jax_keys(ttr, run_modes, modifiers):
    """(logged keys, summary keys) that the JAX package's module functions
    give for a run of the port's trainer ``ttr``: every mode's epoch
    metrics, the validation average, a train row with its angle
    histograms, the parameter and gradient histograms of the model's flax
    tree, and the summaries of init, each checkpoint and each mode."""
    run = FakeRun()
    run.summary.update({"stopped_training_early": False,
                        "max_batch_size": ttr.cfg.batch_size})
    m = ttr.metrics
    JW.log_train_batch(run, ROW, 4, 1.0, lr=1e-4)
    JW.log_angle_histograms(run, np.zeros((1, 2, 24)), np.zeros((1, 2)), 20)
    tree = {}
    for name, path in flax_names(ttr.model).items():
        node = tree
        for seg in path.split("/")[:-1]:
            node = node.setdefault(seg, {})
        node[path.split("/")[-1]] = np.zeros(1)
    JW.watch_params(run, {"params": tree}, grads={"params": tree})
    valid = [mode for mode in run_modes if mode.startswith("valid")]
    for mode in run_modes:
        if mode != "train":
            JW.log_eval_epoch(run, mode, m[mode])
        JW.log_final_epoch_summary(run, mode, m[mode])
    JW.log_avg_validation(run, m, valid)
    for modifier in modifiers:
        JW.log_checkpoint_summary(run, modifier, 1.0, 0, m, False)
    return run.keys(), set(run.summary)


CLI = ["-m", "conv-enc|5,3|1,1", "-dm", "16", "-dih", "32", "-nh", "2",
       "-nl", "1", "-b", "4", "-l", "combined", "--cluster", "True",
       "--use_wandb", "True", "--device", "cpu"]


def test_cli_run_logs_the_jax_keys(fake_wandb, data, tmp_path):
    """Two epochs through the CLI with --use_wandb True: the logged keys
    and the summary keys are those of JAX's module functions for the run,
    and chip_smoke's list; one train row and one pair of angle histograms
    a step (log_wandb_step 1), one histogram a parameter and one a
    gradient each epoch, every one finite; MODEL.txt, the live mirrors and
    finish()."""
    valid = ("valid-10",)
    small = {k: v for k, v in data.items()
             if not k.startswith("valid-") or k in valid}
    path = tmp_path / "d.pt"
    torch.save(small, path)
    trainers = []
    init = Trainer.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        trainers.append(self)

    Trainer.__init__ = keep
    try:
        tcli.main(["--data", str(path), "--name", "w", "--out_dir",
                   str(tmp_path), "-e", "2", "--log_structure_step", "0",
                   "-lvs", "0", *CLI])
    finally:
        Trainer.__init__ = init
    (tr,), (run,) = trainers, fake_wandb.runs
    modes = ["train", *valid, "test"]
    logged, summary = jax_keys(tr, modes, ["best"])
    assert run.keys() == logged
    assert set(run.summary) == summary
    names = sorted(flax_names(tr.model).values())
    assert (logged, summary) == chip_smoke.expected_wandb_keys(
        modes, names, ["best"])
    assert run.init["name"] == "w" and run.finished

    out = tmp_path / "w"
    with open(out / "w.train") as f:
        steps = sum(r["granularity"] == "batch" for r in csv.DictReader(f))
    rows = [p for p, _ in run.logged if "Train Batch RMSE" in p]
    angles = [p for p, _ in run.logged
              if "Predicted Angles (radians)" in p]
    hists = [p for p, _ in run.logged if any(
        k.startswith("parameters/") for k in p)]
    assert len(rows) == len(angles) == steps >= 2
    assert len(hists) == 2
    for payload in hists:
        assert len(payload) == 2 * len(names)
        for k, h in payload.items():
            counts, edges = h.np_histogram
            assert np.isfinite(edges).all() and counts.sum() > 0, k
    assert (out / "MODEL.txt").read_text().startswith(
        "ConvEncoderOnlyTransformer(")
    assert [os.path.relpath(p, out) for p, _, _ in run.saved] == [
        "MODEL.txt", "checkpoints/*", "structures/*", "*.train"]


@pytest.mark.parametrize("device_data", ["true", "false"])
def test_train_rows_and_angle_histograms_on_both_data_paths(
        fake_wandb, data, tmp_path, device_data):
    """On the log_wandb_step cadence, a train row with the row's real
    proteins and the histograms of that step's predictions over its real
    residues: step 0's equal JAX's function on the predictions of the
    initial weights and collate's ids, on the store (LazyBatch.host_seq,
    which equals collate's seq for every batch) and on host batches. With
    use_wandb off no step asks for its predictions."""
    cfg = TConfig(**{**SLICE, "device_data": device_data, "repeat_train": 4,
                     "log_wandb_step": 2, "log_structure_step": 0,
                     "log_val_struct_step": 0, "name": "p",
                     "out_dir": str(tmp_path)})
    tr = Trainer(cfg, device=CPU, data=data)
    state = tr.init_state(torch.Generator().manual_seed(0))
    params0 = {k: v.detach().clone() for k, v in state.params.items()}
    idx0 = next(tr.dm.train_index_batches(
        np.random.default_rng(cfg.seed + state.step)))
    if tr.train_store is not None:
        for idx in tr.dm.train_index_batches(np.random.default_rng(5)):
            plan = DS.plan_batch(tr.dm.train, idx, cfg.bucket_sizes,
                                 tr.dm.max_seq_len)
            np.testing.assert_array_equal(
                DS.LazyBatch(tr.train_store, plan).host_seq,
                collate(tr.dm.train, idx, cfg.bucket_sizes,
                        tr.dm.max_seq_len).seq)
    asked = []
    step = tr.train_step
    tr.train_step = lambda *a, **kw: (asked.append(kw.get("with_pred")),
                                      step(*a, **kw))[1]
    tr.train_epoch(tr.state_from(params0))
    assert asked and not any(asked)  # use_wandb off

    asked.clear()
    tr.wandb_run = run = FakeRun()
    tr.train_epoch(tr.state_from(params0))
    n = len(asked)
    assert asked == [i % 2 == 0 for i in range(n)]
    rows = [p for p, c in run.logged if "Train Batch RMSE" in p]
    assert len(rows) == (n + 1) // 2
    batch = collate(tr.dm.train, idx0, cfg.bucket_sizes, tr.dm.max_seq_len)
    assert rows[0]["Batch size"] == int(batch.protein_mask.sum())
    tr.model.train()
    pred = functional_call(tr.model, params0,
                           model_args(tr.model, torch.as_tensor(batch.seq),
                                      torch.as_tensor(batch.ang)))
    want = FakeRun()
    JW.log_angle_histograms(want, pred.detach().numpy(), batch.seq, 20)
    got = [(p, c) for p, c in run.logged
           if "Predicted Angles (sin cos)" in p]
    assert len(got) == len(rows)
    same_run(types.SimpleNamespace(logged=got[:1], summary={}, saved=[]),
             want)


def test_structure_logger_wandb_branch_matches_jax(fake_wandb, tmp_path):
    """The pred molecule, its .glb, the aligned scene and its RMSD, and the
    PNG, logged with commit=False under JAX's keys and values."""
    seq, crd, mask = _random_structure()
    th = 0.3
    rot = np.array([[np.cos(th), -np.sin(th), 0],
                    [np.sin(th), np.cos(th), 0], [0, 0, 1.0]], np.float32)
    pred = crd @ rot.T + np.float32([2.0, 0.0, -1.0])
    runs = {}
    for pkg, mod in (("t", tsl), ("j", jsl)):
        runs[pkg] = FakeRun()
        logger = mod.StructureLogger(str(tmp_path / pkg),
                                     wandb_run=runs[pkg], save_pngs=True)
        logger.log(3, "V10", seq, pred, crd, mask)
        logger.close()
    (ours, c_ours), = runs["t"].logged
    (theirs, c_theirs), = runs["j"].logged
    assert not c_ours and not c_theirs
    assert list(ours) == list(theirs) == [
        "V10_mol", "V10_3d", "V10_scene", "V10_align_rmsd", "V10_png"]
    assert ours["V10_align_rmsd"] == pytest.approx(
        theirs["V10_align_rmsd"], abs=1e-9) and ours["V10_align_rmsd"] < 1e-4
    for key in ("V10_mol", "V10_png"):  # paths under each logger's directory
        assert os.path.relpath(ours[key].data, tmp_path / "t") == \
            os.path.relpath(theirs[key].data, tmp_path / "j")
    for key in ("V10_3d", "V10_scene"):
        assert ours[key].data == theirs[key].data  # the same file bytes
        assert ours[key].kw == theirs[key].kw == {"file_type": "glb"}
