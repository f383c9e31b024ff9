"""On the card: the control (the reference with TF32 on, put in the
program's place) and a planted fault (half of each batch left out) fail
the cell's limits, and the program passes them, at the cells' widths on
fewer proteins.

    python3 -m pytest benchmark/tests/test_bench_control.py -m needs_cuda
"""
from __future__ import annotations

import json
import shutil

import pytest

from benchmark import control
from conftest import REPO

pytestmark = pytest.mark.needs_cuda


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("small")
    shutil.copytree(REPO / "benchmark", root / "benchmark")
    shutil.copy(REPO / "BENCHMARK.json", root)
    for path in (root / "benchmark" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        for split in traffic["splits"].values():
            split["n"] = min(split["n"], 96)
        path.write_text(json.dumps(traffic))
    return root


@pytest.mark.parametrize("workload", ["conv512_train_l500",
                                      "conv1024_train_l500",
                                      "conv512_eval_l500"])
def test_control_fails_and_program_passes(small_root, workload,
                                          cuda_device, capsys):
    control.main(["--workload", workload, "--seeds", "5",
                  "--control-seeds", "5", "--root", str(small_root)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = json.loads((small_root / f"benchmark/limits/{workload}.json")
                        .read_text())
    assert all(v <= limits[k] for k, v in line["program"].items())
    for variant in ("tf32", "half"):
        assert any(v > limits[k] for k, v in line[variant].items()), variant
