"""A cell, a configuration, a traffic mix, a reference and a per-layer
metric added as new files and entries only: the harness runs them without
an edit, and passes the files' ``program`` fields to the port unchanged."""
from __future__ import annotations

import json

from conftest import make_tiny_root, run_cell

SHADOW = '''"""A reference that a new configuration names: the conv-enc one, which
says on standard error that it ran."""
import sys

from benchmark.reference import train as _train
from benchmark.reference.train import *  # noqa: F401,F403


def train_steps(*args, **kwargs):
    print("shadow reference ran", file=sys.stderr)
    return _train.train_steps(*args, **kwargs)
'''


def test_cell_from_new_files(tmp_path):
    root = make_tiny_root(tmp_path, code=True)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / bench["configs"][0]["file"]).read_text())
    conf.update(name="conv_enc_tiny_wide",
                reference="benchmark.reference.shadow")
    # a TrainConfig field that no configuration of the benchmark sets
    conf["program"].update(d_model=48, n_layers=2, attention_impl="xla")
    (root / "benchmark/configs/conv_enc_tiny_wide.json").write_text(
        json.dumps(conf))
    (root / "benchmark/reference/shadow.py").write_text(SHADOW)
    traffic = json.loads(
        (root / "benchmark/traffic/l500_train.json").read_text())
    traffic["splits"]["train"]["n"] = 24
    # structure logging on, every second step
    traffic["program"]["log_structure_step"] = 2
    (root / "benchmark/traffic/short_train.json").write_text(
        json.dumps(traffic))
    (root / "benchmark/limits/wide_train_short.json").write_text(
        (root / "benchmark/limits/conv512_train_l500.json").read_text())
    (root / "benchmark/metrics/steps_in_window.train.py").write_text(
        "def read(run):\n    return float(run.stretch.steps)\n")
    bench["configs"].append({
        "name": "conv_enc_tiny_wide", "source": "https://example.org",
        "file": "benchmark/configs/conv_enc_tiny_wide.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "wide_train_short", "config": "conv_enc_tiny_wide",
        "traffic": "short_train", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("train_"):
            m["workloads"].append("wide_train_short")
    bench["per_layer"].append({
        "name": "steps_in_window.train", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "train loop",
        "moves": "train_res_per_s", "workloads": ["wide_train_short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    from benchmark import harness, spec
    cfg = harness.program_config(spec.load(root, "wide_train_short"), "out")
    assert (cfg.attention_impl, cfg.log_structure_step, cfg.d_model) == (
        "xla", 2, 48)

    rc, res, err = run_cell(root, "wide_train_short", trace=1, inside=True)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    assert "shadow reference ran" in err
    assert res["metrics"]["steps_in_window.train"]["value"] >= 1
    rc, res, err = run_cell(root, "wide_train_short", trace=0, inside=True)
    assert rc == 0 and set(res["metrics"]) == {
        "train_res_per_s", "train_step_ms_p95", "setup_s"}
