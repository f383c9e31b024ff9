"""The readers of the port's spans (``benchmark/spans.py`` and the metrics
whose source is ``program_span`` there) on the CPU: a tiny ``--trace 1``
training and scoring cell print each of their metrics, above 0 where the
CPU gives them something to wait on; without the port's ``tracing``
module, or without a session of the run's loop, each reader returns
None."""
from __future__ import annotations

import json
import sys
import types

import pytest

from conftest import REPO, run_cell

SPAN_METRICS = [m for m in json.loads(
    (REPO / "BENCHMARK.json").read_text())["per_layer"]
    if m["source"] == "program_span" and m["name"].startswith(
        ("data_", "forward_", "backward_", "optimizer_dispatch", "loop_",
         "host_wait"))]
# on the CPU a training step hands back its metrics without a copy to
# wait for: the training epoch makes no wait
ZERO_ON_CPU = {"host_wait_ms_per_step.train", "host_waits_per_step.train"}


def test_the_span_metrics_and_their_cells():
    train = ["conv512_train_l500", "conv1024_train_l500"]
    want = {f"{n}.train": train for n in (
        "data_ms_per_step", "forward_dispatch_ms_per_step",
        "backward_dispatch_ms_per_step", "optimizer_dispatch_ms_per_step",
        "loop_ms_per_step", "host_wait_ms_per_step", "host_waits_per_step")}
    want.update({f"{n}.eval": ["conv512_eval_l500"] for n in (
        "data_ms_per_step", "host_wait_ms_per_step", "host_waits_per_step")})
    assert {m["name"]: m["workloads"] for m in SPAN_METRICS} == want


@pytest.mark.parametrize("workload", ["conv512_train_l500",
                                      "conv512_eval_l500"])
def test_traced_line_prints_each_span_metric(tiny_root, workload):
    rc, res, err = run_cell(tiny_root, workload, seed=2**31 + 5, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    mine = [m for m in SPAN_METRICS if workload in m["workloads"]]
    assert mine
    for m in mine:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"]
        if m["name"] in ZERO_ON_CPU:
            assert got["value"] == 0, m["name"]
        else:
            assert got["value"] > 0, m["name"]


def fake_run(kind: str):
    return types.SimpleNamespace(kind=kind, traced={"rec": None})


def reader(name: str):
    from benchmark import spec
    cell = spec.load(str(REPO), "conv512_train_l500")
    return cell.reader(name)


@pytest.mark.parametrize("name", [m["name"] for m in SPAN_METRICS])
def test_without_the_ports_recorder_a_reader_reads_nothing(
        monkeypatch, name):
    monkeypatch.setitem(sys.modules, "protein_transformer_tpu_torch.tracing",
                        None)
    kind = name.rsplit(".", 1)[1]
    assert reader(name)(fake_run(kind)) is None


def test_a_session_of_the_other_loop_reads_nothing(monkeypatch):
    from protein_transformer_tpu_torch import tracing
    session = {"spans": [], "count": {"eval.epoch": 1, "eval.step": 3},
               "total_ms": {"eval.epoch": 9.0, "eval.step": 6.0}}
    monkeypatch.setattr(tracing, "last_session", lambda: session)
    assert reader("data_ms_per_step.train")(fake_run("train")) is None
    assert reader("data_ms_per_step.eval")(fake_run("train")) is None
    assert reader("host_waits_per_step.eval")(fake_run("eval")) == 0
    assert reader("data_ms_per_step.eval")(fake_run("eval")) == 0
