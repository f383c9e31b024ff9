"""The port's spans (``protein_transformer_tpu_torch/tracing.py``) on the CPU,
at a tiny width:

* off (no profiler, no ``PTT_LOOP_PROFILE``) a training and a scoring epoch
  record nothing and never enter ``record_function``;
* under ``torch.profiler`` the epochs give the spans' tree: one
  ``train.step`` a step, the forward, backward and optimizer under it,
  every span inside its parent, the scoring step's Kabsch wait under
  ``eval.step`` and the flush's wait under ``eval.flush``;
* each recorded span is a ``user_annotation`` of the exported Chrome trace,
  with the same name, count and nesting (the trace's clock);
* a trace taken again leaves its own session as ``last_session()``;
* the parameters after an epoch are the same bits with spans live and off;
* ``--profile_dir`` writes ``spans.json`` beside ``trace.json``;
* ``tools/analyze_trace.py`` puts each long idle gap of the device down to
  the innermost span the host was in, from a trace without Python stacks;
* counters (``tracing.count``): off they keep nothing; live, the expert
  layers' loads of an 'mla-moe' epoch are copied to the host once, when
  the session closes, one entry a layer a step; they add no ``wait:``
  span.
"""
import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from protein_transformer_tpu_torch import tracing
from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.training.trainer import (
    LoopProfiler, Trainer)
from protein_transformer_tpu_torch.utils import SPANS_FILE, TRACE_FILE

CPU = torch.device("cpu")
TINY = dict(model="conv-enc|5,3|1,1", d_model=16, d_ff=32, n_heads=2,
            n_layers=1, batch_size=2, epochs=1, loss="combined",
            optimizer="adam", bucket_sizes=(16,), max_seq_len=16,
            train_only=True, log_structure_step=0, log_val_struct_step=0,
            cluster=True, batching_order="descending")  # four steps an epoch
# the spans of a training epoch, each with its parent's name
TRAIN_TREE = {"train.batch": "train.epoch", "train.step": "train.epoch",
              "train.forward": "train.step", "train.backward": "train.step",
              "train.optimizer": "train.step", "train.fetch": "train.epoch",
              "train.watchdog": "train.epoch", "train.flush": "train.epoch"}
EVAL_TREE = {"eval.batch": "eval.epoch", "eval.step": "eval.epoch",
             "wait:kabsch_svd": "eval.step", "eval.flush": "eval.epoch",
             "wait:eval.flush": "eval.flush"}


@pytest.fixture(scope="module")
def data():
    return make_dataset(n_train=8, n_eval=4, min_len=8, max_len=16, seed=0)


@pytest.fixture(autouse=True)
def switch_off(monkeypatch):
    monkeypatch.delenv(tracing.SWITCH, raising=False)


def trainer(data, tmp_path, name="tr", **kw) -> Trainer:
    return Trainer(TrainConfig(**{**TINY, **kw}, name=name,
                               out_dir=str(tmp_path)),
                   device=CPU, data=data)


def fresh(tr: Trainer):
    return tr.init_state(torch.Generator().manual_seed(0))


def eval_split(tr: Trainer) -> str:
    return next(s for s, ds in tr.dm.eval_splits.items() if len(ds))


def tree_of(session) -> dict:
    """{name: {its parents' names}} of a session's spans."""
    spans = session["spans"]
    out = collections.defaultdict(set)
    for s in spans:
        out[s["name"]].add(spans[s["parent"]]["name"]
                           if s["parent"] >= 0 else None)
    return dict(out)


def test_off_records_nothing_and_enters_no_record_function(
        data, tmp_path, monkeypatch):
    tr = trainer(data, tmp_path)
    state = fresh(tr)
    tr.train_epoch(state)  # a session may be left from another test

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    last = tracing.last_session()
    state = tr.train_epoch(state)
    tr.eval_epoch(state.params, eval_split(tr))
    assert tracing.last_session() is last
    assert tracing.span("train.step") is tracing.wait("x") is tracing._OFF


def test_profiled_epochs_give_the_span_tree(data, tmp_path):
    tr = trainer(data, tmp_path)
    state = fresh(tr)
    with profile(activities=[ProfilerActivity.CPU]):
        new = tr.train_epoch(state)
    train = tracing.last_session()
    steps = new.step - state.step
    assert steps > 1 and train["count"]["train.step"] == steps
    assert train["count"]["train.epoch"] == 1
    for name in ("train.forward", "train.backward", "train.optimizer",
                 "train.fetch", "train.watchdog"):
        assert train["count"][name] == steps, name
    # one draw a step and the one that finds the feed empty
    assert train["count"]["train.batch"] == steps + 1
    assert tree_of(train) == {"train.epoch": {None},
                              **{k: {v} for k, v in TRAIN_TREE.items()}}
    spans = train["spans"]
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] >= 0:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
            if s["name"] in ("train.forward", "train.optimizer"):
                assert s["step"] == p["step"]
    assert sorted(s["step"] for s in spans if s["name"] == "train.step") \
        == list(range(state.step, new.step))

    with profile(activities=[ProfilerActivity.CPU]):
        tr.eval_epoch(new.params, eval_split(tr))
    ev = tracing.last_session()
    assert ev["id"] == train["id"] + 1
    n = ev["count"]["eval.step"]
    assert n >= 1 and ev["count"]["wait:kabsch_svd"] == n
    assert ev["count"]["wait:eval.flush"] == ev["count"]["eval.flush"] == 1
    assert tree_of(ev) == {"eval.epoch": {None},
                           **{k: {v} for k, v in EVAL_TREE.items()}}


def user_annotations(path) -> list:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X" and not e["name"].startswith(
                "ProfilerStep")]


def annotation_tree(events) -> collections.Counter:
    """(name, innermost enclosing annotation's name) of each annotation."""
    events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    stack, out = [], collections.Counter()
    for e in events:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < (
                e["ts"] + e["dur"] - 1e-3):
            stack.pop()
        out[(e["name"], stack[-1]["name"] if stack else None)] += 1
        stack.append(e)
    return out


@pytest.mark.parametrize("loop", ["train", "eval"])
def test_each_span_is_a_user_annotation_of_the_trace(data, tmp_path, loop):
    tr = trainer(data, tmp_path)
    state = fresh(tr)
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if loop == "train":
            tr.train_epoch(state)
        else:
            tr.eval_epoch(state.params, eval_split(tr))
    prof.export_chrome_trace(path)
    spans = tracing.last_session()["spans"]
    want = collections.Counter(
        (s["name"], spans[s["parent"]]["name"] if s["parent"] >= 0
         else None) for s in spans)
    assert want[(f"{loop}.step", f"{loop}.epoch")] >= 1
    assert annotation_tree(user_annotations(path)) == want


def test_a_retaken_trace_leaves_its_own_session_last(data, tmp_path):
    tr = trainer(data, tmp_path)
    state = fresh(tr)
    firsts = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            new = tr.train_epoch(state)
        firsts.append((tracing.last_session()["id"], state.step, new.step))
        state = new
    (id1, _, _), (id2, lo, hi) = firsts
    last = tracing.last_session()
    assert id2 == id1 + 1 == last["id"]
    assert sorted(s["step"] for s in last["spans"]
                  if s["name"] == "train.step") == list(range(lo, hi))


@pytest.mark.parametrize("live", ["profiler", "switch"])
def test_parameters_are_the_same_bits_with_spans_live(data, tmp_path,
                                                      monkeypatch, live):
    off, on = (trainer(data, tmp_path, name=n) for n in ("off", "on"))
    a = off.train_epoch(fresh(off))
    if live == "switch":
        monkeypatch.setenv(tracing.SWITCH, "1")
        b = on.train_epoch(fresh(on))
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            b = on.train_epoch(fresh(on))
    assert tracing.last_session()["count"]["train.step"] == b.step
    assert a.step == b.step
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_profile_dir_writes_the_spans_beside_the_trace(data, tmp_path):
    out = tmp_path / "trace"
    tr = trainer(data, tmp_path, profile_dir=str(out))
    state = tr.train()
    assert (out / TRACE_FILE).exists()
    with open(out / SPANS_FILE) as f:
        spans = json.load(f)
    assert spans["count"]["train.step"] == state.step
    assert spans["count"]["train.epoch"] == 1
    assert set(spans["total_ms"]) == set(spans["count"])
    assert {s["name"] for s in spans["spans"]} == set(spans["count"])


def test_loop_profiler_counts_each_span_at_its_own_time():
    session = {"spans": [
        {"name": "train.epoch", "parent": -1, "start_ns": 0,
         "end_ns": 10_000_000},
        {"name": "train.step", "parent": 0, "start_ns": 1_000_000,
         "end_ns": 6_000_000},
        {"name": "train.forward", "parent": 1, "start_ns": 1_000_000,
         "end_ns": 4_000_000},
        {"name": "train.flush", "parent": 0, "start_ns": 7_000_000,
         "end_ns": 9_000_000},
        {"name": "wait:train.flush", "parent": 3, "start_ns": 7_000_000,
         "end_ns": 8_500_000}], "count": {"train.step": 1}}
    prof = LoopProfiler.of(session)
    assert prof.steps == 1
    assert prof.t == pytest.approx(
        {"train.step": 2e-3, "train.forward": 3e-3, "train.flush": 0.5e-3,
         "wait:train.flush": 1.5e-3})
    # the phases and the unaccounted rest make up the root's wall time
    assert prof.report(10e-3).endswith("(unaccounted)        3.00 ms/step")


def test_analyze_trace_puts_each_idle_gap_down_to_a_span(tmp_path, capsys):
    """A hand-written trace without Python stacks: three kernels, two idle
    gaps, the host in ``train.forward`` during the first and in
    ``wait:kabsch_svd`` during the second (the longer)."""
    from protein_transformer_tpu_torch.tools import analyze_trace as T

    def x(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 1, "tid": tid}

    events = [x("user_annotation", "train.epoch", 0, 200),
              x("user_annotation", "train.step", 20, 70),
              x("user_annotation", "train.forward", 20, 20),
              x("user_annotation", "wait:kabsch_svd", 60, 30)]
    events += [x("kernel", "k", ts, 10, tid=7) for ts in (0, 50, 110)]
    (tmp_path / TRACE_FILE).write_text(json.dumps({"traceEvents": events}))
    res = T.main([str(tmp_path), "--by", "source"])
    assert res["gap_spans"] == [(0.05, 0.06, "wait:kabsch_svd"),
                                (0.04, 0.01, "train.forward")]
    assert ("longest idle gaps by the span the host was in: 0.050 ms in "
            "wait:kabsch_svd, 0.040 ms in train.forward"
            in capsys.readouterr().out)
    assert T.gap_spans([], [], []) == []


# a tiny 'mla-moe' model: 1 dense and 2 expert layers of 4 experts, top 2
MOE = dict(model="mla-moe", d_model=16, d_ff=32, n_heads=2, n_layers=3,
           dropout=0.0, mla_moe=dict(
               kv_lora_rank=8, qk_nope_head_dim=8, qk_rope_head_dim=4,
               v_head_dim=8, rope_theta=50000.0, first_k_dense_replace=1,
               moe_intermediate_size=8, n_routed_experts=4,
               num_experts_per_tok=2, n_shared_experts=1,
               routed_scaling_factor=2.446, rms_norm_eps=1e-5,
               bias_update_speed=1e-3, seq_aux_alpha=1e-4))


def test_counters_off_keep_nothing(data, tmp_path):
    tr = trainer(data, tmp_path, **MOE)
    state = fresh(tr)
    tr.train_epoch(state)  # a session may be left from another test
    last = tracing.last_session()
    tracing.count("x", torch.ones(3))
    tr.train_epoch(state)
    assert tracing._counters == {}
    assert tracing.last_session() is last


def test_counters_live_are_read_once_at_session_close(data, tmp_path,
                                                      monkeypatch):
    tr = trainer(data, tmp_path, **MOE)
    state = fresh(tr)
    reads = []
    real_read = tracing._read_counters

    def read(counters):
        reads.append(len(tracing._open))
        return real_read(counters)

    monkeypatch.setattr(tracing, "_read_counters", read)
    residues = []
    step = tr.train_step

    def noting(state, batch, *args, **kwargs):
        residues.append(int((batch.seq != tr.cfg.pad_id).sum()))
        return step(state, batch, *args, **kwargs)

    monkeypatch.setattr(tr, "train_step", noting)
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train_epoch(state)
    s = tracing.last_session()
    assert reads == [0]  # once, when the epoch span has closed
    steps = s["count"]["train.step"]
    assert sorted(s["counters"]) == ["moe.load.layers.1", "moe.load.layers.2"]
    step_ids = sorted({sp["step"] for sp in s["spans"]
                       if sp["name"] == "train.step"})
    for c in s["counters"].values():
        assert sorted(c["steps"]) == step_ids and len(c["values"]) == steps
        for v in c["values"]:
            assert len(v) == 4 and sum(v) == int(sum(v)) > 0
    # k = 2 routed experts a real residue, step by step
    for c in s["counters"].values():
        assert [sum(v) for v in c["values"]] == [2 * n for n in residues]


def test_counters_add_no_wait_span(data, tmp_path):
    tr = trainer(data, tmp_path, **MOE)
    state = fresh(tr)
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train_epoch(state)
    s = tracing.last_session()
    assert s["counters"]
    waits = {n for n in s["count"] if n.startswith(tracing.WAIT)}
    assert waits <= {"wait:train.flush"}
