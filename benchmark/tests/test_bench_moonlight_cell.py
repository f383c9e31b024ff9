"""The 'mla-moe' cell (``moonlight_train_l500``) through the harness on the
CPU, its configuration narrowed to d_model 64, 8 experts, top 2 and three
layers of which one is dense, in fp32 and in the configuration's bf16: the
run is correct against ``reference/moonlight.py``, and a traced run reads
the cell's per-layer metrics that the CPU can give (the expert layers'
host ms and their loads); the device's (``moe_step_mfu``,
``moe_gemm_roofline``) come from the card only. The fp8 control and the
half fault of ``moonlight_control.py`` part from the reference far more
than the program does."""
from __future__ import annotations

import json

import pytest
import torch

from conftest import REPO, make_tiny_root, run_cell

CELL = "moonlight_train_l500"
TINY_ARCH = dict(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                 v_head_dim=16, moe_intermediate_size=32, n_routed_experts=8,
                 num_experts_per_tok=2)


def tiny_moonlight_root(root, dtype: str = "float32"):
    root = make_tiny_root(root, code=True)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"]
                 if c["name"] == "moonlight16b_stage1")
    conf = json.loads((REPO / "benchmark/configs/moonlight16b_stage1.json")
                      .read_text())
    conf["program"].update(d_model=64, d_ff=128, n_heads=4, n_layers=3,
                           compute_dtype=dtype)
    conf["program"]["mla_moe"].update(TINY_ARCH)
    (root / entry["file"]).write_text(json.dumps(conf))
    return root


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moonlight_cell_through_the_harness(tmp_path, dtype):
    root = tiny_moonlight_root(tmp_path, dtype)
    rc, res, err = run_cell(root, CELL, seed=2**31 + 5, trace=1,
                            inside=True)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checks"]
    metrics = res["metrics"]
    assert metrics["expert_load_max.train"]["value"] >= 1.0
    assert metrics["moe_dispatch_ms_per_step.train"]["value"] > 0
    assert "moe_step_mfu.train" not in metrics
    assert "moe_gemm_roofline.train" not in metrics
    rc, res, err = run_cell(root, CELL, seed=3, trace=0, inside=True)
    assert rc == 0 and set(res["metrics"]) == {
        "train_res_per_s", "train_step_ms_p95", "setup_s"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_control_and_fault_part_from_the_reference(tmp_path, monkeypatch,
                                                   dtype):
    """The program reads ~1e-7 (bf16 too: the reference takes the
    program's order of operations); the fp8 control and the half fault
    each read some number a hundred times its own."""
    root = tiny_moonlight_root(tmp_path, dtype)
    prog, ctrl = tmp_path / "program.jsonl", tmp_path / "control.jsonl"
    monkeypatch.chdir(root)
    from benchmark import control, moonlight_control
    common = ["--workload", CELL, "--seeds", "4", "--device", "cpu",
              "--root", str(root), "--out"]
    assert control.main(common + [str(prog)]) == 0
    assert moonlight_control.main(common + [str(ctrl)]) == 0
    program = json.loads(prog.read_text().splitlines()[-1])["program"]
    line = json.loads(ctrl.read_text().splitlines()[-1])
    for variant in ("fp8", "half"):
        assert any(line[variant][k] > 100 * max(program[k], 1e-9)
                   for k in program), (variant, line[variant], program)
    assert torch.get_default_dtype() == torch.float32
