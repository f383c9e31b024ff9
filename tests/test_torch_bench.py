"""The port's bench (``protein_transformer_tpu_torch/bench.py``) and its
fresh-process protocol (``tools/bench_protocol.py``) on the CPU.

Each mode runs narrow (d_model 32, L 16) through ``main`` with ``--device
cpu``, its sizes set by the test through keyword arguments; the protocol runs
against a stand-in ``subprocess.run`` that returns what a bench process
prints, so no child process starts. The root bench's own regular
expressions read the step-time line.
"""
import functools
import json
import re
import subprocess
import sys

import pytest
import torch

from protein_transformer_tpu_torch import bench
from protein_transformer_tpu_torch.ops import _build
from protein_transformer_tpu_torch.tools import bench_protocol as P

CPU = torch.device("cpu")
SMALL = dict(d_model=32, d_ff=64, n_heads=2, n_layers=1, b=2, l=16)
# the root tools/bench_protocol.py's two expressions
P50 = re.compile(r"p50: ([\d.]+) ms")
MFU = re.compile(r"MFU ([\d.]+)%")
KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Narrow CPU steps: one intra-op thread runs them as fast as eight and
    does not crawl beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_mode(monkeypatch, capsys, mode, steps, **sizes):
    """``bench.main(["--device", "cpu"])`` under BENCH_MODE=mode with the
    mode narrowed; (its result, the JSON line, stderr)."""
    monkeypatch.setitem(bench.MODES, mode, functools.partial(
        bench.MODES[mode], **{**SMALL, **sizes}))
    monkeypatch.setenv("BENCH_MODE", mode)
    monkeypatch.setenv("BENCH_STEPS", str(steps))
    result = bench.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == KEYS and line["unit"] == "residues/sec/chip"
    assert line == result["line"] and line["value"] > 0
    assert "# device: cpu" in err and "# TF32 off" in err
    return result, line, err


def test_headline(monkeypatch, capsys):
    result, line, err = run_mode(monkeypatch, capsys, "raw", 5)
    assert "B=2xL=16" in line["metric"] and "dm=32 nl=1" in line["metric"]
    # two warm-up steps and eight pairs of 5- and 10-step windows
    assert result["steps_run"] == 2 + 8 * 15
    assert float(P50.search(err).group(1)) == pytest.approx(
        result["p50_ms"], abs=0.006)
    assert "MFU not measured" in err and not MFU.search(err)
    with open(bench.REFERENCE_BENCH) as f:
        ref = json.load(f)["residues_per_sec"]
    assert line["vs_baseline"] == pytest.approx(line["value"] / ref,
                                                abs=0.006)


def test_step_time_line_matches_the_protocols_expressions():
    """On a card the line carries the MFU that the protocol reads."""
    text = bench.step_time_line(0.04189, 0.05134, 8, 5, 3.1, 1, 0.93, 371.2)
    assert float(P50.search(text).group(1)) == 41.89
    assert float(MFU.search(text).group(1)) == 0.9
    assert "p95: 51.34 ms" in text and "devices: 1" in text


def test_headline_first_step_is_the_trainers_step(monkeypatch, tmp_path):
    """At dropout 0 the headline's first warm-up step gives the loss of
    ``Trainer.train_step`` called directly on the same trainer, weights and
    hand-collated batch, taken just before the bench's own steps."""
    monkeypatch.setattr(bench, "ladder_config", functools.partial(
        bench.ladder_config, dropout=0.0))
    direct = {}
    timed = bench.run_headline

    def run_headline(trainer, state, batch, steps):
        assert tuple(batch.seq.shape) == (SMALL["b"], SMALL["l"])
        assert trainer.cfg.dropout == 0.0
        copy = trainer.state_from({k: v.detach().clone()
                                   for k, v in state.params.items()})
        direct["loss"] = float(trainer.train_step(copy, batch)[1][0])
        return timed(trainer, state, batch, steps)

    monkeypatch.setattr(bench, "run_headline", run_headline)
    result = bench.main_headline(CPU, str(tmp_path), 5, **SMALL)
    assert result["first_loss"] == direct["loss"]


def test_trainer_loop(monkeypatch, capsys):
    result, line, err = run_mode(monkeypatch, capsys, "trainer", 2)
    assert line["vs_baseline"] is None
    assert "every 10 train steps" in err and "every 50" in err
    assert re.search(r"# last epoch: \d+ steps in [\d.]+s; sampler batches "
                     r"of \d+-\d+ proteins in B=\d+", err)
    assert result["steps_run"] == 2 * result["steps_per_epoch"] > 0
    assert result["epochs"] == 2


def test_eval(monkeypatch, capsys):
    result, line, err = run_mode(monkeypatch, capsys, "eval", 2, l=20)
    assert "B=2xL=20" in line["metric"] and line["vs_baseline"] is None
    assert re.search(r"# eval step time: [\d.]+ ms", err)
    assert torch.isfinite(result["metrics"]).all()


def test_bench_and_protocol_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main(["--runs", "2"])


def bench_process(p50=None, value=1000.0):
    """What a bench process prints: epoch lines, then the JSON line; the
    step-time line on stderr when it has a p50."""
    line = {"metric": "m", "value": value, "unit": "residues/sec/chip",
            "vs_baseline": None}
    err = "# card: NVIDIA H100 80GB HBM3, 700.00 W\n"
    if p50 is not None:
        err += bench.step_time_line(p50 / 1e3, p50 / 1e3, 8, 5, 1.0, 1, 0.9,
                                    371.2)
    return "[ Epoch 0 ]\n" + json.dumps(line) + "\n", err


@pytest.fixture
def fake_bench(monkeypatch, tmp_path):
    """A stand-in for subprocess.run: each call takes the next outcome
    ("fail", "timeout" or (p50, value)); the calls are recorded. The
    protocol sees a GPU and a build directory under tmp_path."""
    outcomes, calls = [], []

    def run(cmd, **kw):
        calls.append((cmd, kw))
        out = outcomes.pop(0)
        if out == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        if out == "fail":
            return subprocess.CompletedProcess(cmd, 1, "", "Traceback: boom")
        stdout, stderr = bench_process(*out)
        return subprocess.CompletedProcess(cmd, 0, stdout, stderr)

    monkeypatch.setattr(P.subprocess, "run", run)
    monkeypatch.setattr(P, "cuda_device", lambda: CPU)
    build_dir = tmp_path / "torch_kernels"
    build_dir.mkdir()
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.delenv("BENCH_MODE", raising=False)
    return outcomes, calls, build_dir


def protocol_lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def test_protocol_median_and_spread_of_warm_runs(fake_bench, capsys):
    outcomes, calls, build_dir = fake_bench
    (build_dir / "libdrmsd_fwd-0123456789abcdef.so").write_bytes(b"")
    outcomes += [(41.89, 48890.0), (45.0, 45511.1), (43.5, 47081.0)]
    out = P.main(["--runs", "3", "--steps", "30"])
    *rows, last = protocol_lines(capsys)
    assert last == out == {
        "protocol": "median of 3 fresh-process runs", "metric": "p50_ms",
        "median": 43.5, "spread": [41.89, 45.0],
        "spread_pct": round(100 * (45.0 - 41.89) / 43.5, 2),
        "throughput_median": 47081.0, "warm_cache": True}
    assert [(r["run"], r["cold"], r["p50_ms"], r["mfu_pct"])
            for r in rows] == [(0, False, 41.89, 0.9), (1, False, 45.0, 0.9),
                               (2, False, 43.5, 0.9)]
    cmd, kw = calls[0]
    assert cmd == [sys.executable, "-m", "protein_transformer_tpu_torch.bench"]
    assert kw["env"]["BENCH_STEPS"] == "30" and "BENCH_MODE" not in kw["env"]
    assert kw["timeout"] == 600.0 and kw["cwd"] == P.ROOT


def test_protocol_drops_a_cold_run_zero(fake_bench, capsys):
    outcomes, _, build_dir = fake_bench
    # a ptxas log alone is no built library
    (build_dir / "libx-0123456789abcdef.so.ptxas.txt").write_text("")
    outcomes += [(90.0, 20000.0), (42.0, 48000.0), (44.0, 46000.0)]
    out = P.main(["--runs", "3"])
    rows = protocol_lines(capsys)[:-1]
    assert [r["cold"] for r in rows] == [True, False, False]
    assert out["protocol"] == ("median of 2 fresh-process runs (cold run 0 "
                               "discarded)")
    assert out["median"] == 44.0 and out["spread"] == [42.0, 44.0]
    assert out["warm_cache"] is False and out["throughput_median"] == 48000.0
    assert any(build_dir.iterdir())  # the tool deletes nothing


@pytest.mark.parametrize("first", ["fail", "timeout"])
def test_protocol_retries_once(fake_bench, capsys, first):
    outcomes, calls, _ = fake_bench
    outcomes += [first, (42.0, 48000.0), (43.0, 47000.0)]
    out = P.main(["--runs", "2", "--per_run_timeout", "30"])
    lines = protocol_lines(capsys)
    event = {"fail": "run_failed", "timeout": "run_timeout"}[first]
    assert lines[0]["event"] == event and lines[0]["attempt"] == 0
    assert len(calls) == 3 and calls[0][1]["timeout"] == 30.0
    assert out["median"] == 43.0 and out["metric"] == "p50_ms"


def test_protocol_raises_after_the_retry(fake_bench, capsys):
    outcomes, calls, _ = fake_bench
    outcomes += ["fail", "timeout"]
    with pytest.raises(RuntimeError, match="failed 2 times"):
        P.main(["--runs", "2"])
    assert len(calls) == 2
    events = [ln["event"] for ln in protocol_lines(capsys)]
    assert events == ["run_failed", "run_timeout"]


def test_protocol_trainer_mode_takes_the_values(fake_bench, capsys):
    outcomes, calls, build_dir = fake_bench
    (build_dir / "libsidechain-0123456789abcdef.so").write_bytes(b"")
    outcomes += [(None, 50000.0), (None, 52000.0)]
    out = P.main(["--runs", "2", "--mode", "trainer"])
    assert calls[0][1]["env"]["BENCH_MODE"] == "trainer"
    assert calls[0][1]["timeout"] == 1200.0
    assert out["metric"] == "value" and out["median"] == 52000.0
    assert out["spread"] == [50000.0, 52000.0]
