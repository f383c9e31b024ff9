"""Fixtures of the benchmark's own tests: the benchmark's cells narrowed to
widths and protein counts a CPU runs in seconds, in a directory of their
own (``--root``), with every file the cells read copied there."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
TINY_PROGRAM = dict(d_model=32, d_ff=64, n_heads=2, n_layers=1,
                    model="conv-enc|5,3,3|1,1,1")


def make_tiny_root(root: Path, code: bool = False) -> Path:
    """A copy of the benchmark's cells at tiny sizes under ``root``; with
    ``code`` the benchmark's modules too, as a checkout holds them."""
    (root / "benchmark").mkdir(parents=True, exist_ok=True)
    if code:
        shutil.copytree(REPO / "benchmark", root / "benchmark",
                        dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for d in ("metrics", "limits", "traffic"):
        shutil.copytree(REPO / "benchmark" / d, root / "benchmark" / d,
                        dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "benchmark" / "configs").mkdir(exist_ok=True)
    for c in bench["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        conf["program"].update(TINY_PROGRAM)
        conf["conv_kernels"] = [5, 3, 3]
        c["file"] = f"benchmark/configs/tiny_{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(conf))
    for path in (root / "benchmark" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        for split in traffic["splits"].values():
            split["n"] = 48
            split["lengths"] = {"dist": "uniform", "min": 20, "max": 60}
        traffic["program"]["batch_size"] = 1
        path.write_text(json.dumps(traffic))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


def run_cell(root: Path, workload: str, seed: int = 7, trace: int = 0,
             seconds: float = 1.0, inside: bool = False):
    """(exit code, the last stdout line parsed or None, stderr) of one CPU
    run of ``benchmark.run`` in a subprocess; ``inside``: run from ``root``
    (a tiny root made with ``code``), the port found on PYTHONPATH."""
    env = dict(os.environ, PYTHONPATH=str(REPO)) if inside else None
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace), "--device", "cpu", "--root", str(root)],
        cwd=root if inside else REPO, capture_output=True, text=True,
        timeout=600, env=env)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, result, proc.stderr


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)
