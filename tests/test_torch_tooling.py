"""The port's loop tooling against the JAX package's: prefetch, the batch-size
probe (and the CLI's ``-adbs``), the profiler hook and ``LoopProfiler``.

* ``prefetch`` keeps order, bounds its buffer, re-raises the producer's
  error in the consumer and runs ``transform`` on its worker thread;
* ``find_largest_batch_size``: ports of ``tests/test_tooling.py:13-40`` with
  ``torch.cuda.OutOfMemoryError``; for the same fake frontier the port makes
  the same tries as the JAX function and gives the same answer; which errors
  count as running out of memory; the memory is released after each
  failed try, outside the except block;
* ``probe_trainer_batch_size`` on the CPU through both data paths;
* ``-adbs`` replaces the batch size before training (as
  ``tests/test_cli.py:62``); against a step that runs out of memory above
  a frontier, the port's probe makes the JAX probe's tries and gives its
  answer, and the binned sampler at that batch size draws the JAX
  sampler's rows, more than the answer (the residue budget is
  ``batch_size`` x 500: inherited, and the port matches it);
* ``maybe_profile`` writes a Chrome trace on the CPU, and
  ``Trainer.train`` with ``profile_dir`` traces its first epoch;
* ``LoopProfiler``'s report equals the JAX one for the same adds, and
  ``PTT_LOOP_PROFILE=1`` reports the loop's spans as its phases.
"""
import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from protein_transformer_tpu.config import TrainConfig as JConfig
from protein_transformer_tpu.data.dataset import DataModule as JDataModule
from protein_transformer_tpu.training import batch_probe as jprobe
from protein_transformer_tpu.training.trainer import (
    LoopProfiler as JLoopProfiler)
from protein_transformer_tpu_torch.config import TrainConfig as TConfig
from protein_transformer_tpu_torch.data.dataset import DataModule
from protein_transformer_tpu_torch.data.prefetch import prefetch
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.training import batch_probe as probe
from protein_transformer_tpu_torch.training import cli as tcli
from protein_transformer_tpu_torch.training.trainer import (
    METRIC_KEYS, LoopProfiler, Trainer)
from protein_transformer_tpu_torch.utils import TRACE_FILE, maybe_profile

CPU = torch.device("cpu")
TINY = dict(model="conv-enc|5,3|1,1", d_model=16, d_ff=32, n_heads=2,
            n_layers=1, batch_size=2, epochs=1, loss="combined",
            optimizer="adam", bucket_sizes=(16,), max_seq_len=16,
            train_only=True, log_structure_step=0, log_val_struct_step=0,
            cluster=True)


@pytest.fixture(scope="module")
def data():
    return make_dataset(n_train=8, n_eval=2, min_len=8, max_len=16, seed=0)


# ---------------------------------------------------------------- prefetch

def test_prefetch_keeps_order_and_runs_transform_on_its_worker():
    main = threading.get_ident()
    threads = []

    def transform(x):
        threads.append(threading.get_ident())
        return x * 10

    assert list(prefetch(iter(range(7)), size=2, transform=transform)) == [
        10 * i for i in range(7)]
    assert len(threads) == 7 and main not in threads
    assert list(prefetch(iter([]))) == []


def test_prefetch_bounds_its_buffer():
    pulled = []

    def producer():
        for i in range(20):
            pulled.append(i)
            yield i

    it = prefetch(producer(), size=2)
    assert next(it) == 0
    time.sleep(0.3)  # the worker runs ahead as far as the buffer lets it
    # two items in the queue and one in the worker's hand, besides the one
    # consumed
    assert len(pulled) <= 2 + 2
    assert list(it) == list(range(1, 20))


def test_prefetch_reraises_the_producers_error_in_the_consumer():
    def producer():
        yield 1
        yield 2
        raise ValueError("producer failed")

    got = []
    with pytest.raises(ValueError, match="producer failed"):
        for item in prefetch(producer(), size=1):
            got.append(item)
    assert got == [1, 2]
    with pytest.raises(ZeroDivisionError):
        list(prefetch(iter([1, 0]), transform=lambda x: 1 / x))


# ------------------------------------------------------------ batch probe

def oom_above(frontier, calls, error=torch.cuda.OutOfMemoryError):
    def try_batch(b):
        calls.append(b)
        if b > frontier:
            raise error("CUDA out of memory. Tried to allocate 2.00 GiB")
    return try_batch


def test_batch_probe_search():
    got = probe.find_largest_batch_size(oom_above(23, []), verbose=False)
    # frontier is 23, keep 0.8 -> 18
    assert got == int(23 * 0.8)


def test_batch_probe_non_oom_propagates():
    def try_batch(b):
        raise ValueError("boom")

    with pytest.raises(ValueError):
        probe.find_largest_batch_size(try_batch, verbose=False)
    # a RuntimeError that is no allocation failure propagates too
    with pytest.raises(RuntimeError, match="illegal memory access"):
        probe.find_largest_batch_size(
            oom_above(0, [], lambda _m: RuntimeError(
                "CUDA error: an illegal memory access was encountered")),
            verbose=False)


def test_batch_probe_start_too_big():
    with pytest.raises(RuntimeError, match="starting batch"):
        probe.find_largest_batch_size(oom_above(0, []), verbose=False)


@pytest.mark.parametrize("frontier,max_batch", [
    (1, 4096), (2, 4096), (23, 4096), (64, 4096), (1000, 4096),
    (5000, 4096), (37, 40), (3, 5)])
def test_batch_probe_makes_the_jax_tries(frontier, max_batch, capsys):
    ours, theirs = [], []
    got = probe.find_largest_batch_size(oom_above(frontier, ours),
                                        max_batch=max_batch)
    ours_out = capsys.readouterr().out
    want = jprobe.find_largest_batch_size(
        oom_above(frontier, theirs,
                  lambda m: RuntimeError("RESOURCE_EXHAUSTED: " + m)),
        max_batch=max_batch)
    assert ours == theirs and got == want
    assert ours_out == capsys.readouterr().out


@pytest.mark.parametrize("error,oom", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory."), True),
    (RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
                  "`cublasCreate(handle)`"), True),
    (RuntimeError("cuDNN error: CUDNN_STATUS_ALLOC_FAILED"), True),
    (RuntimeError("CUDA error: out of memory"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
    (ValueError("out of memory"), False),
], ids=["torch-oom", "cublas", "cudnn", "cuda-status", "illegal-access",
        "value-error"])
def test_which_errors_are_out_of_memory(error, oom):
    assert probe._is_oom(error) is oom


def test_memory_is_released_after_each_failed_try_outside_except(
        monkeypatch):
    released = []
    monkeypatch.setattr(probe.gc, "collect",
                        lambda: released.append(sys.exc_info()[0]))
    probe.find_largest_batch_size(oom_above(5, []), verbose=False)
    # tries 1 2 4 8(OOM) 6(OOM) 5: two failures, each released with no
    # exception being handled
    assert released == [None, None]


@pytest.mark.parametrize("device_data", ["true", "false"])
def test_probe_trainer_batch_size_on_cpu(data, tmp_path, device_data):
    """The probe trains real steps (nothing runs out of memory on the CPU
    at these sizes, so the frontier is max_batch) on copies: the trainer's
    dropout stream moves, no state is kept."""
    tr = Trainer(TConfig(**TINY, device_data=device_data, name="probe",
                         out_dir=str(tmp_path)), device=CPU, data=data)
    assert (tr.train_store is not None) == (device_data == "true")
    steps = []
    step = tr.train_step
    tr.train_step = lambda state, batch, *a: (
        steps.append((state.step, batch.seq.shape)), step(state, batch, *a))[1]
    assert probe.probe_trainer_batch_size(tr, max_batch=5,
                                          verbose=False) == int(5 * 0.8)
    # tries 1 2 4 then 5; each from step 0, at the longest bucket; the
    # batch padded to its bucket (5 -> 8 rows)
    assert steps == [(0, (1, 16)), (0, (2, 16)), (0, (4, 16)), (0, (8, 16))]


def test_cli_adbs_overrides_batch_size(data, tmp_path, monkeypatch):
    """-adbs wires the batch probe into the CLI (reference train.py:532-551):
    the probe's answer replaces cfg.batch_size before training starts."""
    pt_path = str(tmp_path / "d.pt")
    torch.save(data, pt_path)
    probed, trained = {}, {}

    def fake_probe(trainer, **kw):
        probed["initial_batch"] = trainer.cfg.batch_size
        probed["store"] = trainer.train_store is not None
        return 6

    monkeypatch.setattr(probe, "probe_trainer_batch_size", fake_probe)
    orig_train = Trainer.train

    def spy_train(self, state=None):
        trained["batch_size"] = self.cfg.batch_size
        trained["adbs"] = self.cfg.automatically_determine_batch_size
        return orig_train(self, state)

    monkeypatch.setattr(Trainer, "train", spy_train)
    tcli.main(["--data", pt_path, "--name", "adbs", "--out_dir",
               str(tmp_path), "-m", "enc-only", "-dm", "16", "-dih", "32",
               "-nh", "2", "-nl", "1", "-e", "1", "-b", "4", "-l", "mse",
               "-opt", "adam", "--train_only", "--log_structure_step", "0",
               "-adbs", "True", "--device", "cpu"])
    assert probed == {"initial_batch": 4, "store": True}
    assert trained == {"batch_size": 6, "adbs": False}


@pytest.mark.parametrize("frontier", [3, 6, 13])
def test_probe_answer_and_sampler_rows_match_jax(data, tmp_path, frontier):
    """-adbs and the binned sampler count rows differently, in both
    packages alike: on one dataset, with a step that runs out of memory
    above ``frontier`` rows, the port's probe tries the JAX probe's batches
    at the longest bucket and answers as it does; at that batch size the
    sampler's residue budget (``batch_size`` x 500) draws the JAX sampler's
    rows, every batch more of them than the answer."""
    kw = {k: v for k, v in TINY.items() if k != "cluster"}
    tr = Trainer(TConfig(**kw, device_data="false", name="rows",
                         out_dir=str(tmp_path)), device=CPU, data=data)
    ours, theirs = [], []

    def step(state, batch, *_):
        ours.append(batch.seq.shape)
        if batch.seq.shape[0] > frontier:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return state, torch.zeros(len(METRIC_KEYS))

    def jstep(params, opt_state, step, batch, rng, lr_scale):
        theirs.append(batch.seq.shape)
        if batch.seq.shape[0] > frontier:
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
        return params, opt_state, step, 0, None

    tr.train_step = step
    jcfg = JConfig(**kw).finalize()
    jtr = types.SimpleNamespace(
        dm=JDataModule(data, jcfg), train_store=None, mesh=None, rng=None,
        init_state=lambda: types.SimpleNamespace(params={}, opt_state={},
                                                 step=0),
        _train_step_fn=lambda: jstep)
    got = probe.probe_trainer_batch_size(tr, verbose=False)
    want = jprobe.probe_trainer_batch_size(jtr, verbose=False)
    # a try is padded up to its row bucket, which must fit: 0.8 of it
    assert got == want and 1 <= got <= 0.8 * frontier
    assert ours == theirs and {s[1] for s in ours} == {TINY["max_seq_len"]}
    at = {**kw, "batch_size": got}
    rows = [list(DataModule(data, TConfig(**at).finalize())
                 .train_index_batches(np.random.default_rng(7))),
            list(JDataModule(data, JConfig(**at).finalize())
                 .train_index_batches(np.random.default_rng(7)))]
    assert len(rows[0]) == len(rows[1]) > 0
    for a, b in zip(*rows):
        np.testing.assert_array_equal(a, b)
        assert len(a) > got


# --------------------------------------------------------------- profiling

def trace_events(directory):
    with open(os.path.join(directory, TRACE_FILE)) as f:
        return json.load(f)["traceEvents"]


def test_maybe_profile_writes_a_chrome_trace_on_cpu(tmp_path):
    with maybe_profile(None):
        pass
    assert not os.listdir(tmp_path)
    with maybe_profile(str(tmp_path / "prof")):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    names = {e.get("name") for e in trace_events(tmp_path / "prof")}
    assert "aten::mm" in names


def test_train_traces_its_first_epoch(data, tmp_path):
    tr = Trainer(TConfig(**{**TINY, "epochs": 2}, name="prof",
                         out_dir=str(tmp_path),
                         profile_dir=str(tmp_path / "trace")),
                 device=CPU, data=data)
    seen = []
    epoch = tr.train_epoch
    tr.train_epoch = lambda *a: (seen.append(
        os.path.exists(tmp_path / "trace" / TRACE_FILE)), epoch(*a))[1]
    tr.train()
    assert seen == [False, True]  # written when the first epoch ends
    names = [e.get("name", "") for e in trace_events(tmp_path / "trace")]
    assert any(n.startswith("aten::") for n in names)
    assert "aten::index" in names  # the store's gather is in the trace


def test_loop_profiler_report_equals_jax(monkeypatch, data, tmp_path,
                                         capsys):
    adds = [("train.step", 0.004), ("train.batch", 0.0015),
            ("train.forward", 0.002), ("train.flush", 0.0001),
            ("train.watchdog", 0.00002), ("train.structure_log", 0.0),
            ("wait:train.flush", 0.003)]
    ours, theirs = LoopProfiler(), JLoopProfiler()
    for prof in (ours, theirs):
        for phase, dt in adds:
            prof.add(phase, dt)
        prof.steps = 3
    assert ours.report(0.0125) == theirs.report(0.0125)
    assert LoopProfiler().report(0.0) == JLoopProfiler().report(0.0)

    monkeypatch.setenv("PTT_LOOP_PROFILE", "1")
    tr = Trainer(TConfig(**TINY, name="loopprof", out_dir=str(tmp_path)),
                 device=CPU, data=data)
    state = tr.train_epoch(tr.init_state(torch.Generator().manual_seed(0)))
    report = capsys.readouterr().err
    assert report.startswith(f"# loop profile: {state.step} steps, ")
    # the spans of the loop and of the step; on the CPU no copy is in
    # flight: no wait in the flush
    for phase in ("train.batch", "train.step", "train.forward",
                  "train.backward", "train.optimizer", "train.fetch",
                  "train.watchdog", "train.flush", "(unaccounted)"):
        assert f"#   {phase:<18} " in report, phase
    assert "wait:" not in report
