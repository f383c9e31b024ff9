"""The port's host loop, checkpoints and CLI against the JAX package's.

* ``checkpoint_policy`` against the JAX function over a table of cases;
* ``CheckpointManager``: a round trip bit for bit, loading with
  ``weights_only=True``, a missing sidecar, ``restart_opt``;
* the port's parser against the JAX parser, flag by flag, and the flag
  values that ask for parts the port does not have yet;
* the check that the monitored split is one the run evaluates;
* two epochs of ``Trainer.train`` against the JAX ``Trainer.train`` on one
  tiny synthetic dataset (dropout 0, the same weights through the bridge,
  each package's default data path, the device store, train plus two
  validation splits plus test): every epoch
  metric within 2e-5 relative (the per-step bound of the five-step A/B in
  tests/test_torch_train.py) plus 1e-6 absolute, the same plateau and
  early-stopping state, the same checkpoints written after each epoch, CSV
  files with the same header and row count; then a resumed third epoch;
* the NaN watchdog aborts at the offending step, not at the window's end.

The port side runs on the CPU (``--device cpu``) and never imports JAX:
only this test file does.
"""
import argparse
import csv
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protein_transformer_tpu.config import TrainConfig as JConfig
from protein_transformer_tpu.training import checkpoint as jckpt
from protein_transformer_tpu.training import cli as jcli
from protein_transformer_tpu.training.trainer import (
    Trainer as JTrainer, TrainState as JTrainState)
from protein_transformer_tpu_torch.config import TrainConfig as TConfig
from protein_transformer_tpu_torch.data import synthetic as tsyn
from protein_transformer_tpu_torch.data.dataset import DataModule, collate
from protein_transformer_tpu_torch.models.flax_import import (
    flax_to_state_dict)
from protein_transformer_tpu_torch.training import checkpoint as tckpt
from protein_transformer_tpu_torch.training import cli as tcli
from protein_transformer_tpu_torch.training import metrics as M
from protein_transformer_tpu_torch.training.trainer import Trainer

from test_torch_train import flax_params

CPU = torch.device("cpu")
VALID = ("valid-10", "valid-90")
# one length bin and a residue budget of 4 x 500: two steps per epoch of 45
# rows (drawn with replacement) padded to B=48 x L=44, one shape to compile
LOOP = dict(model="conv-enc|5,3|1,1", d_model=32, d_ff=64, n_heads=2,
            n_layers=2, batch_size=4, loss="combined", dropout=0.0,
            bucket_sizes=(48,), max_seq_len=48, optimizer="adam",
            lr_scheduling="plateau", learning_rate=1e-3, bins=1,
            repeat_train=10, epochs=2, early_stopping_metric="valid-90-drmsd")
STEPS = 2


@pytest.fixture(scope="module")
def data():
    d = tsyn.make_dataset(n_train=8, n_eval=2, min_len=30, max_len=44,
                          seed=0)
    for split in [k for k in d if k.startswith("valid-")]:
        if split not in VALID:
            del d[split]
    return d


# ---------------------------------------------------------------- policy

HOUR = 3600.0
POLICY_CASES = {
    "first-loss": (5.0, [5.0], 0.0, 0.0),
    "improved": (3.0, [5.0, 4.0, 3.0], 0.0, 0.0),
    "not-improved": (4.5, [5.0, 4.0, 4.5], 0.0, 0.0),
    "tie-is-not-better": (4.0, [5.0, 4.0, 4.0], 0.0, 0.0),
    "interval-passed": (4.5, [5.0, 4.0, 4.5], 2 * HOUR, 1.0),
    "interval-not-passed": (4.5, [5.0, 4.0, 4.5], 0.5 * HOUR, 1.0),
    "improved-and-interval-passed": (3.0, [5.0, 4.0, 3.0], 2 * HOUR, 1.0),
    "empty-history": (3.0, [], 2 * HOUR, 1.0),
    "interval-off": (4.5, [5.0, 4.0, 4.5], 100 * HOUR, 0.0),
}


@pytest.mark.parametrize("case", list(POLICY_CASES))
def test_checkpoint_policy_matches_jax(case):
    cur, history, age, interval = POLICY_CASES[case]
    last = time.time() - age
    got = tckpt.checkpoint_policy(cur, list(history), last, interval)
    assert got == jckpt.checkpoint_policy(cur, list(history), last, interval)
    assert got in ("best", "latest", None)


def test_checkpoint_policy_refuses_more_than_one_process():
    """It refused more than one process until the port had meshes; now it
    takes process 0's time decision (tests/test_torch_parallel.py holds
    that across two real processes), which alone is its own, as the JAX
    package's."""
    for case in ("interval-passed", "interval-not-passed", "first-loss"):
        cur, history, age, interval = POLICY_CASES[case]
        last = time.time() - age
        got = tckpt.checkpoint_policy(cur, list(history), last, interval,
                                      process_count=2)
        assert got == jckpt.checkpoint_policy(cur, list(history), last,
                                              interval, process_count=2)


# ------------------------------------------------------------ checkpoints

def port_trainer(data, out_dir, **kw):
    cfg = TConfig(**{**LOOP, "out_dir": str(out_dir), "name": "port", **kw})
    return Trainer(cfg, device=CPU, data=data)


def stepped_state(tr, n=2):
    """A state after n optimizer updates, so that the moments are set."""
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = collate(tr.dm.train, np.arange(4), tr.cfg.bucket_sizes,
                    tr.dm.max_seq_len)
    for _ in range(n):
        state, _ = tr.train_step(state, batch)
    return state


arrays_of = Trainer._arrays


def test_checkpoint_round_trip_is_bit_for_bit(data, tmp_path):
    tr = port_trainer(data, tmp_path, optimizer="adam")
    state = stepped_state(tr)
    mgr = tckpt.CheckpointManager(tmp_path / "ckpt")
    assert not mgr.exists("best") and mgr.restore_raw("best") is None
    meta = {"epoch": 3, "elapsed": 12.5, "plateau": tr.plateau.state_dict(),
            "early_stop": tr.early_stop.state_dict(),
            "best_history": [3.0, np.float32(2.5)]}
    mgr.save("best", arrays_of(state), meta)
    assert mgr.exists("best")
    assert sorted(os.listdir(mgr.directory)) == ["best", "best.meta.json"]
    # tensors and plain Python values only
    raw = torch.load(mgr._path("best"), weights_only=True)
    assert not any(t.requires_grad for t in raw["params"].values())
    arrays, got_meta = mgr.restore("best", arrays_of(state))
    assert list(arrays["params"]) == list(state.params)
    for k, v in state.params.items():
        assert torch.equal(arrays["params"][k], v.detach())
    for name in ("mu", "nu"):
        assert list(arrays["opt_state"][name]) == list(state.params)
        for a, b in zip(arrays["opt_state"][name].values(),
                        getattr(state.opt_state, name)):
            assert torch.equal(a, b)
    assert arrays["opt_state"]["count"] == state.opt_state.count == 2
    assert arrays["step"] == state.step == 2
    assert got_meta == {**meta, "best_history": [3.0, 2.5]}
    # a template of another structure is refused
    other = arrays_of(state)
    other["params"] = {**other["params"], "extra": torch.zeros(1)}
    with pytest.raises(ValueError, match="keys differ"):
        mgr.restore("best", other)
    shorter = arrays_of(state)
    shorter["opt_state"] = {"count": 0, "mu": {}, "nu": {}}
    with pytest.raises(ValueError, match="keys differ"):
        mgr.restore("best", shorter)
    reshaped = arrays_of(state)
    name = next(iter(state.params))
    reshaped["params"] = {**reshaped["params"], name: torch.zeros(3)}
    with pytest.raises(ValueError, match="expected a tensor of shape"):
        mgr.restore("best", reshaped)


def test_resume_restart_opt_and_missing_sidecar(data, tmp_path):
    tr = port_trainer(data, tmp_path)
    state = stepped_state(tr)
    tr.plateau.step(4.0)
    tr.early_stop.update(0, 4.0)
    tr._save_checkpoint(state, epoch=0, cur_loss=4.0, history=[4.0])
    saved = torch.load(tr.ckpt._path("best"), weights_only=True)

    def fresh(**kw):
        tr2 = port_trainer(data, tmp_path, **kw)
        return tr2, tr2.init_state(torch.Generator().manual_seed(9))

    # plain resume: everything restored
    tr2, init = fresh()
    got = tr2.maybe_restore(init)
    assert got.step == 2 and tr2.start_epoch == 1
    assert got.opt_state.count == 2
    assert tr2._best_history == [4.0]
    assert tr2.plateau.state_dict() == tr.plateau.state_dict()
    assert tr2.early_stop.state_dict() == tr.early_stop.state_dict()
    for k, v in got.params.items():
        assert torch.equal(v, saved["params"][k]) and v.requires_grad
    for k, a in zip(got.params, got.opt_state.mu):
        assert torch.equal(a, saved["opt_state"]["mu"][k])
    # a resumed run draws other dropout masks than the run's first steps
    assert tr2.dropout_generator.initial_seed() == tr2.cfg.seed + 2

    # restart_opt: weights and step restored, optimizer fresh
    tr3, init = fresh(restart_opt=True, optimizer="sgd")
    got = tr3.maybe_restore(init)
    assert got.step == 2 and tr3.start_epoch == 1
    assert got.opt_state is init.opt_state and got.opt_state.count == 0
    assert all(torch.equal(v, saved["params"][k])
               for k, v in got.params.items())

    # restart: nothing loaded
    tr4, init = fresh(restart=True)
    assert tr4.maybe_restore(init) is init and tr4.start_epoch == 0

    # another checkpoint name that does not exist: nothing loaded
    tr5, init = fresh(load_chkpt="latest")
    assert tr5.maybe_restore(init) is init

    # a missing sidecar: epoch-0 bookkeeping, weights restored
    os.remove(tr.ckpt._path("best") + ".meta.json")
    tr6, init = fresh()
    got = tr6.maybe_restore(init)
    assert tr6.start_epoch == 0 and tr6._best_history == []
    assert got.step == 2
    assert all(torch.equal(v, saved["params"][k])
               for k, v in got.params.items())


def test_resume_with_another_optimizer_needs_restart_opt(data, tmp_path):
    """An SGD run's checkpoint (no moments) resumed with -opt adam: the
    restore raises and names --restart_opt; with it the run resumes from
    the weights and the step, with fresh Adam moments."""
    tr = port_trainer(data, tmp_path, optimizer="sgd")
    state = stepped_state(tr)
    tr._save_checkpoint(state, epoch=0, cur_loss=4.0, history=[4.0])
    saved = torch.load(tr.ckpt._path("best"), weights_only=True)
    assert saved["opt_state"]["mu"] == {}

    adam = port_trainer(data, tmp_path, optimizer="adam")
    init = adam.init_state(torch.Generator().manual_seed(9))
    with pytest.raises(ValueError, match="--restart_opt") as err:
        adam.maybe_restore(init)
    assert "-opt adam" in str(err.value)

    adam = port_trainer(data, tmp_path, optimizer="adam", restart_opt=True)
    init = adam.init_state(torch.Generator().manual_seed(9))
    got = adam.maybe_restore(init)
    assert got.step == 2 and adam.start_epoch == 1
    assert got.opt_state is init.opt_state and got.opt_state.count == 0
    assert len(got.opt_state.mu) == len(got.params)
    assert all(torch.equal(v, saved["params"][k])
               for k, v in got.params.items())


# ------------------------------------------------------------------- CLI

# flags of the JAX parser's "TPU Args" group that the port's "GPU Args"
# group does not have, and the reverse; --drmsd_impl is in both with the
# backends' own choices
ONLY_JAX = {"prng_impl"}
ONLY_PORT = {"device", "sidechain_impl"}


def actions_of(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def type_name(action):
    return getattr(action.type, "__name__", None)


def test_parser_has_the_jax_flag_surface():
    ours, theirs = (actions_of(tcli.create_parser()),
                    actions_of(jcli.create_parser()))
    assert set(theirs) - set(ours) == ONLY_JAX
    assert set(ours) - set(theirs) == ONLY_PORT
    for dest in set(ours) & set(theirs):
        a, b = ours[dest], theirs[dest]
        assert a.option_strings == b.option_strings, dest
        assert type(a) is type(b), dest
        assert type_name(a) == type_name(b), dest
        assert a.default == b.default, dest
        assert a.nargs == b.nargs, dest
        if dest != "drmsd_impl":
            assert a.choices == b.choices, dest
    assert ours["drmsd_impl"].choices == ["auto", "cuda", "torch"]
    assert ours["sidechain_impl"].choices == ["auto", "cuda", "torch"]
    assert ours["device"].default == "cuda"
    groups = {g.title for g in tcli.create_parser()._action_groups}
    assert "GPU Args" in groups and "TPU Args" not in groups


def test_config_from_args_matches_jax_on_shared_fields():
    argv = ["--data", "d.pt", "--name", "run", "-lr", "3e-4", "-e", "7",
            "-b", "4", "-es", "5", "-nws", "100", "-cg", "0.5", "-l",
            "lndrmsd", "--lr_scheduling", "noam", "-esm", "valid-70-mse",
            "--eval_train", "True", "-opt", "adam", "-s", "3", "-m",
            "conv-enc|11,5|2,1", "-dm", "64", "-dih", "128", "-nh", "4",
            "-nl", "3", "-do", "0.2", "--weight_decay", "False",
            "--restart_opt", "--checkpoint_time_interval", "1.5",
            "--load_chkpt", "latest", "--out_dir", "o", "-c", "True",
            "--backbone_loss", "--grad_semantics", "reference",
            "--train_eval_downsample", "0.5", "--log_structure_step", "0"]
    ours, theirs = tcli.config_from_args(argv), jcli.config_from_args(argv)
    theirs = theirs.to_dict()
    for field, value in ours.to_dict().items():
        # the port's own fields: its kernel switches and the 'mla-moe'
        # family, which the JAX package does not have
        if field in ("drmsd_impl", "sidechain_impl", "mla_moe"):
            continue
        assert value == theirs[field], field
    assert (ours.es_mode, ours.es_metric) == ("valid-70", "mse")
    assert (ours.conv1_size, ours.conv2_reduc, ours.model) == (11, 1.0,
                                                               "conv-enc")
    default = tcli.config_from_args([])
    assert default.early_stopping_metric == "train-combined"
    assert (default.drmsd_impl, default.sidechain_impl) == ("auto", "auto")


NOW_PORTED = {
    "pngs": (["--save_pngs", "True"],
             dict(save_pngs=True, log_structure_step=10,
                  log_val_struct_step=50)),
    "enc-dec": (["-m", "enc-dec", "-fctf", "0.5", "-fsstf", "0.25"],
                dict(model="enc-dec", add_sos_eos=True,
                     fraction_complete_tf=0.5, fraction_subseq_tf=0.25)),
    "adbs": (["-adbs", "True"],
             dict(automatically_determine_batch_size=True)),
    "device-data": (["--device_data", "true", "--device_data_max_mb", "64"],
                    dict(device_data="true", device_data_max_mb=64)),
    "profile": (["--profile_dir", "p"], dict(profile_dir="p")),
    "bfloat16": (["--compute_dtype", "bfloat16"],
                 dict(compute_dtype="bfloat16")),
    "wandb": (["--use_wandb", "True", "--log_wandb_step", "5"],
              dict(use_wandb=True, log_wandb_step=5)),
    "mesh": (["--mesh_shape", "2", "2", "--mesh_axes", "data", "model"],
             dict(mesh_shape=[2, 2], mesh_axes=["data", "model"])),
}


@pytest.mark.parametrize("case", list(NOW_PORTED))
def test_flags_of_parts_now_ported_are_accepted_and_kept(case):
    argv, fields = NOW_PORTED[case]
    ours, theirs = tcli.config_from_args(argv), jcli.config_from_args(argv)
    for field, value in fields.items():
        assert getattr(ours, field) == getattr(theirs, field) == value, field


def test_accepted_values_of_those_flags_pass():
    cfg = tcli.config_from_args(
        ["--device_data", "auto", "--attention_impl", "xla", "--save_pngs",
         "True", "--log_structure_step", "0", "-lvs", "0",
         "--sequential_drmsd_loss", "--no_cuda"])
    assert cfg.loss == "combined"
    assert cfg.attention_impl == "xla"
    # the flash kernels are in the port: the value is accepted and kept
    flash = tcli.config_from_args(["--attention_impl", "flash"])
    assert flash.attention_impl == "flash"
    assert tcli.config_from_args([]).attention_impl == "auto"


def test_cli_without_a_gpu_raises_and_never_uses_the_cpu(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    path = tmp_path / "data.pt"
    torch.save(data, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--data", str(path), "--out_dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "run")
    with pytest.raises(ValueError, match="must not contain '_'"):
        tcli.main(["--name", "a_b", "--device", "cpu"])


@pytest.mark.parametrize("kw,match", [
    (dict(train_only=True), "--train_only never evaluates one"),
    (dict(early_stopping_metric="valid-50-drmsd"),
     "split 'valid-50' is not evaluated during training "
     r"\(available: train, valid-10, valid-90\)"),
    (dict(early_stopping_metric="test-drmsd"),
     "split 'test' is not evaluated during training"),
], ids=["train-only", "absent-split", "test-split"])
def test_monitored_split_must_be_evaluated(data, tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        port_trainer(data, tmp_path, **kw)
    with pytest.raises(ValueError, match=match):
        JTrainer(JConfig(**{**LOOP, "out_dir": str(tmp_path), "name": "j",
                            **kw}), data=data, use_mesh=False)


def test_train_eval_batches_match_jax(data):
    from protein_transformer_tpu.data.dataset import DataModule as JDataModule
    kw = dict(batch_size=2, train_eval_downsample=0.5, bucket_sizes=(48,),
              max_seq_len=48)
    ours = DataModule(data, TConfig(**kw).finalize())
    theirs = JDataModule(data, JConfig(**kw).finalize())
    got = list(ours.train_eval_batches(np.random.default_rng(3)))
    want = list(theirs.train_eval_batches(np.random.default_rng(3)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for field in ("seq", "ang", "crd", "crd_mask", "protein_mask",
                      "n_res"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field))
    assert list(ours.eval_splits) == list(theirs.eval_splits) == [
        *VALID, "test"]


# ---------------------------------------------------- the two-epoch A/B

def recording_saves(trainer, log):
    """Note the modifier of every checkpoint the trainer writes."""
    save = trainer.ckpt.save

    def recorded(modifier, arrays, meta):
        log.append((meta["epoch"], modifier))
        return save(modifier, arrays, meta)

    trainer.ckpt.save = recorded


def read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.fixture(scope="module")
def loop_ab(data, tmp_path_factory):
    """Two epochs of Trainer.train in both packages from the same weights."""
    out = tmp_path_factory.mktemp("loop")
    jtr = JTrainer(JConfig(**LOOP, name="jax", out_dir=str(out),
                           log_structure_step=0, log_val_struct_step=0),
                   data=data, use_mesh=False)
    assert jtr.use_device_data
    jbatch = next(jtr.dm.train_batches(np.random.default_rng(0)))
    assert jbatch.seq.shape == (48, 44)
    params = flax_params(jtr, jbatch)
    jsaves, tsaves = [], []
    recording_saves(jtr, jsaves)
    jtr.train(JTrainState(params, jtr.tx.init(params),
                          jnp.zeros((), jnp.int32)))

    ttr = port_trainer(data, out, log_structure_step=0,
                       log_val_struct_step=0)
    assert ttr.use_device_data
    recording_saves(ttr, tsaves)
    state = ttr.train(ttr.state_from(flax_to_state_dict(params, ttr.model)))
    return dict(jtr=jtr, ttr=ttr, state=state, jsaves=jsaves, tsaves=tsaves,
                out=out)


def test_two_epochs_of_train_match_jax(loop_ab):
    """Measured on the CPU: epoch metrics within 4e-6 relative."""
    jtr, ttr = loop_ab["jtr"], loop_ab["ttr"]
    assert loop_ab["state"].step == 2 * STEPS
    worst = 0.0
    for mode in ("train", *VALID, "test"):
        jm, tm = jtr.metrics[mode], ttr.metrics[mode]
        for key in (f"epoch-{k}" for k in M.LOSS_KEYS):
            if mode == "train" and key == "epoch-rmsd-full":
                assert tm[key] == jm[key] == 0.0  # not computed in training
                continue
            assert np.isfinite(tm[key]) and tm[key] > 0, (mode, key)
            np.testing.assert_allclose(tm[key], jm[key], rtol=2e-5,
                                       atol=1e-6, err_msg=f"{mode} {key}")
            worst = max(worst, abs(tm[key] - jm[key]) / abs(jm[key]))
        for hist in ("drmsd", "combined", "lndrmsd", "mse"):
            got = tm[f"epoch-history-{hist}"]
            assert len(got) == (1 if mode == "test" else 2)
            np.testing.assert_allclose(got, jm[f"epoch-history-{hist}"],
                                       rtol=2e-5, atol=1e-6)
    print(f"worst relative gap of an epoch metric: {worst:.2e}")
    np.testing.assert_allclose(ttr.metrics["history-lr"],
                               jtr.metrics["history-lr"], rtol=1e-7)


def test_plateau_early_stopping_and_checkpoints_match_jax(loop_ab):
    jtr, ttr = loop_ab["jtr"], loop_ab["ttr"]
    assert loop_ab["tsaves"] == loop_ab["jsaves"]
    assert loop_ab["tsaves"] and loop_ab["tsaves"][0] == (0, "best")
    for ours, theirs in ((ttr.plateau.state_dict(),
                          jtr.plateau.state_dict()),
                         (ttr.early_stop.state_dict(),
                          jtr.early_stop.state_dict())):
        assert set(ours) == set(theirs)
        for key, value in ours.items():
            if key == "best":
                np.testing.assert_allclose(value, theirs[key], rtol=2e-5)
            else:
                assert value == theirs[key], key
    best = os.path.join(ttr.out_dir, "checkpoints", "best.meta.json")
    with open(best) as f, open(best.replace("port", "jax")) as jf:
        meta, jmeta = json.load(f), json.load(jf)
    assert set(meta) == set(jmeta)
    assert meta["epoch"] == jmeta["epoch"]
    np.testing.assert_allclose(meta["best_history"], jmeta["best_history"],
                               rtol=2e-5)


def test_csv_and_config_files_match_jax(loop_ab):
    out = loop_ab["out"]
    header, rows = read_csv(out / "port" / "port.train")
    jheader, jrows = read_csv(out / "jax" / "jax.train")
    assert header == jheader and len(rows) == len(jrows)
    # per epoch: the train batches, the train epoch, the validation splits;
    # then test
    assert len(rows) == 2 * (STEPS + 1 + len(VALID)) + 1
    assert [r[6:8] for r in rows] == [r[6:8] for r in jrows]
    np.testing.assert_allclose(
        np.array([r[:6] for r in rows], float),
        np.array([r[:6] for r in jrows], float), rtol=2e-5, atol=1e-6)
    with open(out / "port" / "config.json") as f, \
            open(out / "jax" / "config.json") as jf:
        ours, theirs = json.load(f), json.load(jf)
    assert ours["angle_means"] == theirs["angle_means"]
    skip = ("name", "drmsd_impl", "sidechain_impl", "mla_moe")
    for field, value in ours["config"].items():
        if field not in skip:
            assert value == theirs["config"][field], field


def test_resumed_run_continues_from_the_checkpoint(loop_ab, data):
    out = loop_ab["out"]
    best = os.path.join(out, "port", "checkpoints", "best")
    saved = torch.load(best, weights_only=True)
    with open(best + ".meta.json") as f:
        saved_epoch = json.load(f)["epoch"]
    n_rows = len(read_csv(out / "port" / "port.train")[1])

    tr = port_trainer(data, out, epochs=3)
    restored = tr.maybe_restore(
        tr.init_state(torch.Generator().manual_seed(5)))
    assert tr.start_epoch == saved_epoch + 1
    assert restored.step == saved["step"] == (saved_epoch + 1) * STEPS
    for k, v in restored.params.items():
        assert torch.equal(v, saved["params"][k])

    tr = port_trainer(data, out, epochs=3)
    state = tr.train()
    epochs_run = 3 - (saved_epoch + 1)
    assert state.step == saved["step"] + epochs_run * STEPS
    header, rows = read_csv(out / "port" / "port.train")
    assert header[0] == "drmsd"  # appended to, not rewritten
    assert len(rows) == n_rows + epochs_run * (STEPS + 1 + len(VALID)) + 1
    assert len(tr.metrics["train"]["epoch-history-drmsd"]) == epochs_run
    assert len(tr._best_history) == 3


# ------------------------------------------------------------ NaN watchdog

def test_nan_watchdog_does_not_wait_for_the_window(data, tmp_path):
    """The blow-up update is step 0's: step 1's loss is not finite. With a
    window of 32 steps and 5 steps in the epoch the loop still aborts at
    step 1, after step 0's row went to the metrics and the CSV."""
    tr = port_trainer(data, tmp_path, loss="mse", optimizer="sgd",
                      learning_rate=1e9, clip=0.0, batch_size=1, bins=-1,
                      repeat_train=5, early_stopping_metric=None)
    assert tr.FLUSH_EVERY == 32
    n_steps = len(list(tr.dm.train_index_batches(np.random.default_rng(0))))
    assert n_steps >= 3
    state = tr.init_state(torch.Generator().manual_seed(0))
    taken = []
    step = tr.train_step
    tr.train_step = lambda *a, **k: (taken.append(1), step(*a, **k))[1]
    logger = M.CsvLogger(str(tmp_path / "nan.train"), "mse")
    with pytest.raises(FloatingPointError, match="A nan loss has occurred"):
        tr.train_epoch(state, logger)
    logger.close()
    assert len(taken) == 2  # within the JAX loop's one to two dispatches
    assert tr.metrics["n_batches"] == 1
    assert tr.metrics["history-lr"] == [0.0, 1e9]
    assert len(read_csv(tmp_path / "nan.train")[1]) == 1
