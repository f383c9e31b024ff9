"""Each cell end to end on the CPU at tiny widths: the contract's line,
the per-layer readers, and the exits without a card or a port."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import REPO, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload",
                         [w["name"] for w in _bench()["workloads"]])
def test_cell_line(tiny_root, workload):
    rc, res, err = run_cell(tiny_root, workload, seed=2**31 + 17)
    assert rc == 0, err[-3000:]
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in _bench()["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    for name, c in res["checks"].items():
        assert f"check {name} " in err.strip().splitlines()[-len(
            res["checks"]):][list(res["checks"]).index(name)]


@pytest.mark.parametrize("workload", ["conv512_train_l500",
                                      "conv512_eval_l500"])
def test_traced_line(tiny_root, workload):
    rc, res, err = run_cell(tiny_root, workload, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    kind = "train" if "train" in workload else "eval"
    # the CPU gives the host-side readers something to read, and the
    # device readers nothing
    assert f"pad_share.{kind}" in res["metrics"]
    assert not any(k.startswith(("step_mfu", "device_", "gemm_"))
                   for k in res["metrics"])


def test_no_card_no_result(tiny_root):
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "conv512_train_l500", "--seed", "1", "--seconds", "1",
         "--trace", "0", "--root", str(tiny_root)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 2 and proc.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "conv512_train_l500", "--seed", "1", "--seconds", "1",
         "--trace", "0", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_jax_loaded_no_result(tiny_root, tmp_path):
    """A run in a process that has loaded a module named jax ends without a
    result (a stand-in jax, loaded at start-up by sitecustomize)."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text("import jax\n")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "conv512_eval_l500", "--seed", "1", "--seconds", "0.1",
         "--trace", "0", "--device", "cpu", "--root", str(tiny_root)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(tmp_path), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 3 and proc.stdout.strip() == ""
    assert "jax" in proc.stderr


def test_nothing_of_jax_is_loaded():
    """After importing every module of the harness and running its
    imports, no top-level name is jax, jaxlib, flax or the JAX package;
    the reference and the data maker import nothing of the port."""
    code = (
        "import sys, benchmark.reference.train, benchmark.proteins, "
        "benchmark.weights, benchmark.frozen.flops, benchmark.frozen.trace\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', "
        "'protein_transformer_tpu', 'protein_transformer_tpu_torch'}))\n"
        "import benchmark.harness, benchmark.run\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', "
        "'protein_transformer_tpu'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:2] == ["[]", "[]"]
    pattern = re.compile(r"^\s*(from|import)\s+protein_transformer_tpu", re.M)
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        assert not pattern.search(path.read_text()), path
