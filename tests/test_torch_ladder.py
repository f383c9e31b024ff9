"""The port's config ladder, trace and attention-bench levels on the CPU.

* ``tools/bench_ladder.py``: ``LADDER`` and each entry's ``TrainConfig``
  equal the JAX tool's (read from its source with ``ast``: importing it
  turns on JAX's compilation cache), so do the FLOPs a step; one step's
  loss and gradients match the JAX step at dropout 0 for config 1 at its
  own size, config 3's family and loss and config 5's loss (lndrmsd with
  the backbone term) at a narrow width (gates of
  ``test_torch_train.py::test_one_step_loss_and_gradients_match_jax``);
  the paired-window arithmetic under a fake clock; the probe subprocess's
  ``MAXB`` parsing and the step-down onto the JAX package's collate
  lattice, with a fake subprocess; the tool end to end with ``--device
  cpu`` (no device figure, no MFU) and without it (raises);
* ``tools/analyze_trace.py`` on a hand-written Chrome trace (one device
  event per category, known totals, per-step division, idle gaps) and on
  a real CPU trace of a narrow drmsd step written by
  ``tools/trace_ladder.py`` (forward and backward operations attributed to
  the NeRF and the optimizer through the trace's own links);
* ``tools/bench_attention.py``'s op-level difference helpers and both new
  levels at (2, 2, 16, 32) through the plain versions.

Cost: 30-35 s alone, ~10 s of it imports (three small JAX compiles with
XLA's backend optimisation off, four CPU traces).
"""
import ast
import dataclasses
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from protein_transformer_tpu.config import TrainConfig as JConfig
from protein_transformer_tpu.data.dataset import (
    bucket_batch_size as jbucket_batch_size, collate as jcollate)
from protein_transformer_tpu.training import flops as JF
from protein_transformer_tpu.training.trainer import (
    Trainer as JTrainer, compute_losses as jcompute_losses)
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.models.flax_import import (
    flax_to_state_dict)
from protein_transformer_tpu_torch.ops import attention as A
from protein_transformer_tpu_torch.tools import analyze_trace as T
from protein_transformer_tpu_torch.tools import bench_attention as BA
from protein_transformer_tpu_torch.tools import bench_ladder as BL
from protein_transformer_tpu_torch.tools import trace_ladder as TL
from protein_transformer_tpu_torch.training import flops as F
from protein_transformer_tpu_torch.training.trainer import Trainer

from test_torch_train import NOISE_ONLY, device_batch, flax_params

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(ROOT, "tools", "bench_ladder.py")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's steps here are narrow: one intra-op thread runs them as
    fast as eight, and does not crawl when six test workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_tool_tree():
    with open(JAX_TOOL) as f:
        return ast.parse(f.read())


def jax_ladder() -> dict:
    """The JAX tool's LADDER: {idx: dict(...)} of literals."""
    for node in jax_tool_tree().body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "LADDER":
            return {ast.literal_eval(k): {kw.arg: ast.literal_eval(kw.value)
                                          for kw in v.keywords}
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError("no LADDER in the JAX tool")


def jax_tool_config(idx, b, dtype="float32", dropout=0.1, optimizer="adam",
                    clip=1.0):
    """The TrainConfig that the JAX tool's bench_config builds: its own
    ``TrainConfig(...)`` expression, evaluated on its names."""
    fn = next(n for n in jax_tool_tree().body
              if isinstance(n, ast.FunctionDef) and n.name == "bench_config")
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "TrainConfig")
    spec = jax_ladder()[idx]
    names = dict(TrainConfig=JConfig, spec=spec, b=b, l=spec["l"], idx=idx,
                 dtype=dtype, dropout=dropout, optimizer=optimizer, clip=clip)
    return eval(compile(ast.Expression(call), JAX_TOOL, "eval"), names)


def test_ladder_equals_the_jax_tools():
    assert BL.LADDER == jax_ladder()


SHARED_FIELDS = sorted(
    {f.name for f in dataclasses.fields(JConfig)} - {"out_dir", "prng_impl"})


@pytest.mark.parametrize("idx", sorted(BL.LADDER))
def test_each_config_matches_the_jax_tools_field_by_field(idx, tmp_path):
    b = BL.LADDER[idx]["b"]
    for kw in (dict(), dict(dtype="bfloat16", dropout=0.0, optimizer="sgd",
                            clip=0.0)):
        ours = BL.ladder_config(idx, b, str(tmp_path), **kw).finalize()
        theirs = jax_tool_config(idx, b, **kw).finalize()
        for name in SHARED_FIELDS:
            assert getattr(ours, name) == getattr(theirs, name), name
        spec = BL.LADDER[idx]
        assert (F.train_step_flops(ours, b, spec["l"])
                == JF.train_step_flops(theirs, b, spec["l"]))


# one-step A/Bs: (ladder entry, overrides of its width, batch)
NARROW = dict(d_model=32, d_ff=64, n_heads=2, n_layers=1)
AB_CASES = {"config1": (1, {}, 8, 64),
            "config3-narrow": (3, NARROW, 2, 32),
            "config5-loss-narrow": (5, NARROW, 2, 32)}
# the JAX step's HLO compiled with XLA's backend optimisation off: half
# the compile time of these A/Bs on the CPU, which is most of their cost
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.mark.parametrize("case", list(AB_CASES))
def test_one_step_loss_and_gradients_match_jax(case, tmp_path):
    """Gates of the flagship slice's A/B: loss within 1e-5 relative, each
    gradient within 1e-3 of its largest JAX entry (the key biases, whose
    exact gradient is zero, within 1e-6 of the model's largest)."""
    idx, width, b, length = AB_CASES[case]
    cfg = BL.ladder_config(idx, b, str(tmp_path), dropout=0.0,
                           length=length, **width)
    assert cfg.loss == BL.LADDER[idx]["loss"]
    assert cfg.backbone_loss == BL.LADDER[idx]["backbone_loss"]
    jcfg = JConfig(**{f: getattr(cfg, f) for f in SHARED_FIELDS},
                   out_dir=str(tmp_path / "jax"))
    data = make_dataset(n_train=min(b, 64), n_eval=2, min_len=length - 1,
                        max_len=length, seed=0)
    tr = Trainer(cfg, CPU, data)
    jtr = JTrainer(jcfg, data=data, use_mesh=False)
    batch = BL.ladder_batch(tr, b)
    jbatch = jcollate(jtr.dm.train, np.resize(np.arange(len(jtr.dm.train)),
                                              b),
                      jcfg.bucket_sizes, jtr.dm.max_seq_len)
    for field in ("seq", "ang", "ang_mask", "crd", "crd_mask",
                  "protein_mask"):
        np.testing.assert_array_equal(getattr(batch, field).numpy(),
                                      getattr(jbatch, field))
    params = flax_params(jtr, jbatch)
    dev = device_batch(jbatch)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jcompute_losses(jtr.model, p, dev, jtr.cfg)[0])).lower(
            params).compile(FAST_COMPILE)(params)
    as_port = lambda tree: flax_to_state_dict(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree), tr.model)
    state = tr.state_from(as_port(params))
    want = as_port(grads)
    ours, _, got = tr.loss_and_grads(state.params, batch)
    assert abs(float(ours.detach()) - float(loss)) <= 1e-5 * abs(float(loss))
    top = max(float(g.abs().max()) for g in want.values())
    for name, g in zip(state.params, got):
        scale = (1e-3 * top if name.endswith(NOISE_ONLY)
                 else float(want[name].abs().max()))
        assert float((g - want[name]).abs().max()) <= 1e-3 * scale, name


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_paired_windows_cancel_each_windows_fixed_cost():
    clock = FakeClock()
    per_step, windows = 0.0125, []

    def run(n):
        clock.now += n * per_step

    def sync():  # a fixed cost that grows from window to window
        windows.append(clock.now)
        clock.now += 0.05 + 0.001 * ((len(windows) - 1) // 2)

    samples = BL.paired_samples(
        lambda n: BL.timed_window(run, n, sync, clock), 5, 8)
    assert len(samples) == 8 and len(windows) == 16
    np.testing.assert_allclose(samples, per_step, rtol=0, atol=1e-12)
    assert BL.window_steps(30) == 5 and BL.window_steps(120) == 12
    assert BL.window_steps(10) == 5


def fake_subprocess(stdout, returncode=0, stderr=""):
    calls = []

    def run(argv, **kw):
        calls.append((argv, kw))
        return types.SimpleNamespace(returncode=returncode, stdout=stdout,
                                     stderr=stderr)
    return run, calls


@pytest.mark.parametrize("maxb", [1, 2, 5, 12, 50, 193, 200, 250, 700, 1000])
@pytest.mark.parametrize("multiple", [1, 2, 4])
def test_probe_answer_steps_down_onto_the_jax_collate_lattice(maxb, multiple):
    run, calls = fake_subprocess(f"[batch-probe] b=4 fits\nMAXB=1\n"
                                 f"[batch-probe] max={maxb}\nMAXB={maxb}\n")
    want = max(1, int(0.8 * maxb))
    while want > 0 and jbucket_batch_size(want, multiple) != want:
        want -= 1
    if want == 0:  # the JAX tool's loop never ends here
        with pytest.raises(RuntimeError, match="no batch of the collate"):
            BL.probe_batch(5, "bfloat16", multiple, run=run)
        return
    assert BL.probe_batch(5, "bfloat16", multiple, run=run) == (maxb, want)
    argv, kw = calls[0]
    assert argv[1:3] == ["-m",
                         "protein_transformer_tpu_torch.tools.bench_ladder"]
    assert argv[3:] == ["--configs", "5", "--dtype", "bfloat16",
                        "--probe-only", "--device", "cuda"]
    assert ROOT in kw["env"]["PYTHONPATH"].split(os.pathsep)


@pytest.mark.parametrize("stdout,code", [("[batch-probe] b=4 OOM\n", 1),
                                         ("no answer\n", 0)])
def test_a_failed_probe_raises_with_its_stderr(stdout, code):
    run, _ = fake_subprocess(stdout, code, stderr="x" * 3000 + "the end")
    with pytest.raises(RuntimeError, match="the end$"):
        BL.probe_batch(5, "float32", 1, run=run)


def test_the_tool_without_a_gpu_raises_and_with_cpu_gives_the_jax_keys(
        capsys, monkeypatch):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BL.main(["--configs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.main(["--config", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BA.main(["--level", "op"])
    # one pair of windows (the arithmetic of eight is held above): the
    # CPU's steps are slow under a loaded test run
    monkeypatch.setattr(BL, "WINDOW_REPEATS", 1)
    (line,) = BL.main(["--configs", "1", "--steps", "1", "--batch", "2",
                       "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == line
    jax_keys = ("config", "loss", "b", "l", "dtype", "dropout", "optimizer",
                "clip", "step_ms", "step_ms_p95", "res_per_sec",
                "tflops_per_step", "mfu")
    assert set(jax_keys) <= set(line)
    assert (line["config"], line["b"], line["l"], line["loss"]) == (
        1, 2, 64, "mse")
    assert line["tflops_per_step"] == round(F.train_step_flops(
        BL.ladder_config(1, 2, "-"), 2, 64) / 1e12, 4)
    assert np.isfinite(line["loss_value"]) and line["tf32"] is False
    # the CPU gives no device figure and no MFU
    for key in ("mfu", "card", "device_ops", "device_ms", "idle_share",
                "syncs_per_step"):
        assert line[key] is None, key
    # two warm-up steps and a pair of 5- and 10-step windows
    assert line["steps_run"] == 2 + 15


# ---------------------------------------------------------------- traces

def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def launched(kernel_name, ts, dur, corr, at, tid=1, cat="kernel"):
    """A device event and the runtime call at host time ``at`` that
    launched it."""
    return [x("cuda_runtime", "cudaLaunchKernel", at, 1.0, tid,
              correlation=corr),
            {**x(cat, kernel_name, ts, dur, tid=99, correlation=corr),
             "pid": 0}]


def hand_trace():
    """Two steps of a made-up trace: per step one device event of each
    category, the optimizer's and the NeRF's under their Python frames,
    one NeRF kernel launched from the backward thread."""
    pkg = "protein_transformer_tpu_torch/"
    names = {"K1b drmsd_fwd_grad":
             "void k1_tile_kernel<true, true, false>(float const*, int)",
             "k1_epilogue_kernel": "void k1_epilogue_kernel<true, true>(int)",
             "K2a sidechain_fwd": "sidechain_fwd_kernel(float const*)",
             "flash_attn_bwd": "void flash_attn_bwd_kernel<64>(BwdArgs)",
             "convolution": "void cudnn::winograd_nonfused::fprop<float>()",
             "GEMM": "ampere_sgemm_128x64_nn",
             "copies": "Memcpy HtoD (Pageable -> Device)",
             "elementwise and reduction":
             "void at::native::vectorized_elementwise_kernel<4, "
             "at::native::(anonymous namespace)::AddFunctor<float>>(int)",
             "other": "some_library_kernel"}
    events, corr, ts = [], 0, 0.0
    for step in range(2):
        base = 10_000.0 * step
        for i, (cat, name) in enumerate(names.items()):
            corr += 1
            kind = "gpu_memcpy" if cat == "copies" else "kernel"
            events += launched(name, base + 100 * i, 10.0 + i, corr,
                               base + i, cat=kind)
        # the optimizer: a foreach kernel under training/optim.py
        events.append(x("python_function",
                        f"{pkg}training/optim.py(120): update", base + 50,
                        20))
        events.append(x("cpu_op", "aten::_foreach_add_", base + 55, 5))
        corr += 1
        events += launched("void at::native::multi_tensor_apply_kernel<>()",
                           base + 2000, 30.0, corr, base + 56)
        # the NeRF forward op and its backward on another thread, linked
        events.append(x("python_function", f"{pkg}ops/nerf.py(51): nerf",
                        base + 80, 10))
        events.append(x("cpu_op", "aten::mul", base + 81, 2))
        events.append({"ph": "s", "id": step + 1, "pid": 7, "tid": 1,
                       "ts": base + 81, "cat": "fwdbwd", "name": "fwdbwd"})
        events.append(x("cpu_op", "MulBackward0", base + 500, 10, tid=2))
        events.append({"ph": "f", "id": step + 1, "pid": 7, "tid": 2,
                       "ts": base + 500, "cat": "fwdbwd", "name": "fwdbwd",
                       "bp": "e"})
        events.append(x("cpu_op", "aten::mul", base + 501, 3, tid=2))
        corr += 1
        events += launched("void at::native::elementwise_kernel<128>()",
                           base + 3000, 40.0, corr, base + 502, tid=2)
    return {"traceEvents": events}


def test_analyze_trace_by_source_on_a_hand_written_trace(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(hand_trace()))
    res = T.main([str(tmp_path), "--by", "source", "--steps", "2"])
    cats = res["categories"]
    order = ["K1b drmsd_fwd_grad", "k1_epilogue_kernel", "K2a sidechain_fwd",
             "flash_attn_bwd", "convolution", "GEMM", "copies",
             "elementwise and reduction", "other"]
    for i, cat in enumerate(order):
        assert cats[cat] == {"ms": (10.0 + i) / 1e3, "count": 1.0}, cat
    assert cats["optimizer"] == {"ms": 0.030, "count": 1.0}
    assert cats["NeRF"] == {"ms": 0.040, "count": 1.0}
    assert {c for c, row in cats.items() if row["count"]} == set(order) | {
        "optimizer", "NeRF"}
    total = sum(10.0 + i for i in range(len(order))) + 30 + 40
    assert res["total_ms"] == pytest.approx(total / 1e3)
    assert sum(r["ms"] for r in cats.values()) == pytest.approx(
        res["total_ms"])
    assert res["device_events"] == len(order) + 2
    assert res["sources"]["ops/nerf.py(51): nerf"] == pytest.approx(0.040)
    # busy spans: 9 kernels 100 us apart, then two more, per step
    window = 10_000.0 + 3000 + 40
    assert res["window_ms"] == pytest.approx(window / 1e3)
    assert res["busy_ms"] == pytest.approx(2 * total / 1e3)
    assert res["idle_share"] == pytest.approx(1 - 2 * total / window)
    assert res["gaps_ms"][0] == pytest.approx(((10_000 - 3040) / 1e3,
                                               3040 / 1e3))
    assert len(res["gaps_ms"]) == 5
    out = capsys.readouterr().out
    assert "TOTAL" in out and "idle share" in out


def test_analyze_trace_by_op_strips_templates_and_parameters(tmp_path,
                                                             capsys):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(hand_trace()))
    ops = T.main([str(path)])["ops"]
    assert ops["at::native::vectorized_elementwise_kernel"] == [2 * 17.0, 2]
    assert ops["k1_tile_kernel"] == [20.0, 2]
    assert ops["Memcpy HtoD"] == [2 * 16.0, 2]
    assert T.base_name("fusion.123") == "fusion"
    assert "TOTAL (device events)" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        T.find_trace(str(tmp_path / "empty"))


def test_a_real_cpu_trace_links_backward_ops_to_their_forward_source(
        tmp_path):
    """A narrow config-3 step (enc-only, drmsd) traced on the CPU: every
    backward operation of the NeRF resolves through the trace's fwdbwd
    flows to ops/nerf.py or protein/geometry.py, the optimizer's to
    training/optim.py; the trace holds no device event."""
    cfg = BL.ladder_config(3, 2, str(tmp_path), length=32, d_model=32,
                           d_ff=64, n_heads=2, n_layers=1)
    tr = BL.ladder_trainer(cfg, CPU)
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = BL.ladder_batch(tr, 2)

    def step():
        nonlocal state
        state = tr.train_step(state, batch)[0]

    step()
    path = str(tmp_path / "trace.json")
    assert TL.trace_steps(step, 1, path, on_card=False) == 1
    events = T.load_events(path)
    links = T.Launches(events)
    cats = {}
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"].startswith("aten::"):
            backward = any(a["name"].endswith("Backward0")
                           for a in links.ancestors(e))
            cat = T.category_of(e["name"], links.frames(e))
            cats.setdefault((cat, backward), set()).add(e["name"])
    assert ("NeRF", False) in cats and ("NeRF", True) in cats
    assert ("optimizer", False) in cats
    assert "aten::_foreach_norm" in cats[("optimizer", False)] | cats.get(
        ("optimizer", True), set())
    res = T.by_source(events)
    assert res["total_ms"] == 0 and res["idle_share"] is None


def test_trace_ladder_cli_writes_a_chrome_trace(tmp_path, capsys):
    path = TL.main(["--config", "1", "--steps", "1", "--batch", "2",
                    "--dtype", "float32", "--device", "cpu",
                    "--logdir", str(tmp_path / "tr")])
    assert path == str(tmp_path / "tr" / "trace.json")
    assert T.find_trace(str(tmp_path / "tr")) == path
    assert any(e.get("cat") == "cpu_op" for e in T.load_events(path))
    assert "trace written to" in capsys.readouterr().out


# ---------------------------------------------------------- attention levels

def test_op_level_difference_helpers_read_valid_rows_only():
    q, k, v, valid, scale = BA.op_inputs(CPU, (2, 2, 16, 64))
    assert q.shape == (2, 2, 16, 32) and scale == pytest.approx(32 ** -0.5)
    # the JAX tool's draws: three normals, then the valid lengths
    rng = np.random.default_rng(0)
    for t in (q, k, v):
        np.testing.assert_array_equal(
            t.numpy(), rng.normal(size=(2, 2, 16, 32)).astype(np.float32))
    n_valid = np.maximum(rng.integers(8, 17, 2), 1)
    np.testing.assert_array_equal(valid.sum(1).numpy(), n_valid)

    def plain(q, k, v):
        return A.flash_self_attention_torch(q, k, v, valid, sm_scale=scale)

    out = plain(q, k, v)
    pad = int(valid[1].sum())
    bumped = out.clone()
    if pad < 16:
        bumped[1, 0, pad] += 5.0       # a pad row: not read
        assert BA.valid_rows_diff(out, bumped, valid) == 0.0
    bumped[0, 1, 0, 3] += 0.25         # a valid row
    assert BA.valid_rows_diff(out, bumped, valid) == pytest.approx(0.25)
    grads = BA.valid_rows_grads(plain, q, k, v, valid)
    again = BA.valid_rows_grads(
        lambda q, k, v: A.flash_self_attention(q, k, v, valid,
                                               sm_scale=scale), q, k, v,
        valid)
    assert BA.grads_diff(grads, again) == 0.0
    if pad < 16:  # pad query rows are out of the reduction
        assert float(grads[0][1, :, pad:].abs().max()) == 0.0
    moved = (grads[0], grads[1] + 0.5, grads[2])
    assert BA.grads_diff(moved, grads) == pytest.approx(0.5)


def test_op_and_eval_levels_run_through_the_plain_versions():
    (row,) = BA.bench_op(CPU, shapes=((2, 2, 16, 64),), calls=1, repeats=1)
    assert row["fwd_max_abs_diff"] == 0.0 and row["grad_max_abs_diff"] == 0.0
    # one pair of one-call windows on a loaded CPU: a time, of any sign
    for key in ("xla_fwd_ms", "flash_fwd_ms", "xla_fwdbwd_ms",
                "flash_fwdbwd_ms"):
        assert np.isfinite(row[key]), key
    res = BA.bench_eval_step(CPU, b=2, length=32, d_model=32, n_layers=1,
                             n_heads=2, calls=1, repeats=1)
    assert res["metrics_max_abs_diff"] == 0.0
    assert np.isfinite(res["xla_eval_ms"]) and np.isfinite(
        res["flash_eval_ms"])
    assert all(np.isfinite(v) for v in res["metrics_flash"].values())
    assert BA.eval_config("flash", 4, 500, 1024, 6, 8, "-").loss == "lndrmsd"
