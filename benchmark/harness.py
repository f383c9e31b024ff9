"""One run of one cell: set-up, the measured window, the traced stretch and
the comparison with the reference.

Set-up makes the cell's proteins and weights from the seed, builds the
port's ``Trainer`` on them (its device store holds the splits) from the
``program`` fields of the configuration and traffic files, and then:

* training cells: the first epoch, ``Trainer.train_epoch`` from the seed
  weights, whose first steps the comparison reads (``probe.Probe``), then
  one step of each (rows, length) shape of the traffic that the first
  epoch did not reach;
* scoring cells: one ``Trainer.eval_epoch`` over the split, which reaches
  every shape the window uses.

The window then runs whole epochs of the same call until ``seconds`` are
up. With ``trace`` the window is followed by one more epoch under
``torch.profiler``. Once the window has closed and the memory peak is
read, the program is freed and the reference follows the captured steps or
scores a sample of the window's batches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import correct
from benchmark.frozen import trace as T
from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data import device_store as DS
from protein_transformer_tpu_torch.data.dataset import (
    bucket_batch_size, bucket_length)
from protein_transformer_tpu_torch.training.trainer import (
    METRIC_KEYS, Trainer)
from benchmark.probe import Probe

CAPTURED_STEPS = 3
EVAL_SAMPLE = 6


def program_config(cell, out_dir: str) -> TrainConfig:
    """The files' ``program`` fields as they are, and what a benchmark run
    fixes: the run's seed, no wandb, quiet output, a temporary out_dir."""
    t = cell.traffic
    return TrainConfig(
        **cell.program(), seed=t["run_seed"],
        train_only=t["loop"] == "train", cluster=True, use_wandb=False,
        name=cell.name, out_dir=out_dir)


@dataclasses.dataclass
class Session:
    cell: object
    seed: int
    device: torch.device
    splits: dict
    trainer: Trainer
    probe: Probe
    state: object = None
    params: dict | None = None
    warm_outputs: object = None
    out_dir: str = ""


def _train_shapes(trainer) -> dict:
    """{(rows, length): index array} for every shape the binned sampler
    can make of the training split: each length bin's rows at each length
    bucket its proteins reach."""
    dm, cfg = trainer.dm, trainer.cfg
    ds, budget = dm.train, cfg.batch_size * cfg.max_seq_len
    out = {}
    for b, members in ds.bin_map.items():
        n = max(1, int(budget / ds.hist_bins[b]))
        lens = np.minimum(ds.lens[members], dm.max_seq_len)
        for top in np.unique(lens):
            lb = bucket_length(int(top), cfg.bucket_sizes, dm.max_seq_len)
            key = (bucket_batch_size(n, dm.batch_multiple), lb)
            if key not in out:
                fit = members[lens <= top]
                longest = members[lens == top][:1]
                out[key] = np.r_[longest, np.resize(fit, n - 1)]
    return out


def setup(cell, seed: int, device: torch.device, warm: bool = True
          ) -> Session:
    spec = cell.config
    splits, data = cell.generator().dataset(cell.traffic, seed, device)
    w0 = cell.weights().make(spec, seed, data["settings"]["angle_means"],
                             device)
    out_dir = tempfile.mkdtemp(prefix="bench_")
    trainer = Trainer(program_config(cell, out_dir), device, data)
    shapes = {k: tuple(p.shape) for k, p in trainer.model.named_parameters()}
    if shapes != {k: tuple(v.shape) for k, v in w0.items()}:
        raise ValueError(f"{cell.config['name']}: the port's model and the "
                         "reference's disagree on the parameters")
    state = trainer.state_from(w0)
    del w0
    train = cell.traffic["loop"] == "train"
    probe = Probe(trainer, {k: p.lens for k, p in splits.items()},
                  capture=CAPTURED_STEPS if train else 0)
    s = Session(cell, seed, device, splits, trainer, probe,
                out_dir=out_dir)
    if train:
        probe.start("train")
        while probe.calls < CAPTURED_STEPS:
            calls = probe.calls
            state = trainer.train_epoch(state)
            if probe.calls == calls:
                raise RuntimeError("Trainer.train_epoch made no call of the "
                                   "train_step that the probe wraps")
        seen = set(probe.stop().shapes)
        if warm:
            for idx in _train_shapes(trainer).values():
                plan = DS.plan_batch(trainer.dm.train, idx,
                                     trainer.cfg.bucket_sizes,
                                     trainer.dm.max_seq_len,
                                     trainer.dm.batch_multiple)
                if (len(plan.idx_padded), plan.lb) in seen:
                    continue
                seen.add((len(plan.idx_padded), plan.lb))
                state, _ = probe.raw_train_step(
                    state, trainer.train_store.batch(plan))
        s.state = state
    else:
        s.params = state.params
        del state
        s.probe.start("eval")
        trainer.eval_epoch(s.params, cell.traffic["eval_split"])
        s.warm_outputs = s.probe.stop()
        if not s.warm_outputs.steps:
            raise RuntimeError("Trainer.eval_epoch made no call of the "
                               "eval_step that the probe wraps")
    _sync(device)
    return s


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def epoch(s: Session) -> None:
    if s.cell.traffic["loop"] == "train":
        s.state = s.trainer.train_epoch(s.state)
    else:
        s.trainer.eval_epoch(s.params, s.cell.traffic["eval_split"])


def stretch(s: Session, seconds: float):
    """Whole epochs that start before ``seconds`` are up."""
    rec = s.probe.start(s.cell.traffic["loop"])
    t0 = time.perf_counter()
    while True:
        epoch(s)
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(s.device)
    rec.seconds = time.perf_counter() - t0
    if not rec.steps:
        raise RuntimeError("the window's epochs made no step that the probe "
                           "wraps")
    return s.probe.stop()


def traced_epoch(s: Session) -> dict:
    """One epoch under the profiler: its steps, the wall seconds of the
    epoch between two synchronisations, and the trace's device events by
    category, their union and the longest idle gaps."""
    on_card = s.device.type == "cuda"
    box = {}

    def fn():
        _sync(s.device)
        rec = s.probe.start(s.cell.traffic["loop"])
        t0 = time.perf_counter()
        epoch(s)
        _sync(s.device)
        rec.seconds = time.perf_counter() - t0
        box["rec"] = s.probe.stop()

    prof, taken = T.traced(fn, on_card, with_stack=True)
    path = os.path.join(tempfile.gettempdir(),
                        f"bench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    del prof
    try:
        events = T.load_events(path)
    finally:
        os.remove(path)
    rec = box["rec"]
    devs = T.device_events(events)
    links = T.Launches(events)
    cats: dict = {}
    for e in devs:
        c = T.category_of(e.get("name", ""), links.stack_of(e))
        row = cats.setdefault(c, [0.0, 0])
        row[0] += e["dur"] / 1e6
        row[1] += 1
    busy, _, gaps = T.busy_and_gaps(devs)
    origin = min((e["ts"] for e in devs), default=0.0)
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "python_function" and "dur" in e]
    return {"rec": rec, "traces": taken, "n_events": len(devs),
            "categories": cats, "busy_s": busy / 1e6,
            "window_s": rec.seconds,
            "gaps": [(_host_frame(host, origin + at + g / 2), g / 1e6)
                     for g, at in gaps[:10]]}


def _host_frame(host_events, t_us: float) -> str:
    """The innermost frame of the port or the benchmark running at t."""
    best = None
    for e in host_events:
        if e["ts"] <= t_us <= e["ts"] + e["dur"] and (
                "protein_transformer_tpu_torch/" in e["name"]
                or "benchmark/" in e["name"]):
            if best is None or e["dur"] < best["dur"]:
                best = e
    if best is None:
        return "(no frame of the port)"
    name = best["name"]
    for key in ("protein_transformer_tpu_torch/", "benchmark/"):
        if key in name:
            return key + name.split(key, 1)[1]
    return name


# ---------------------------------------------------------------- correct


def free_program(s: Session) -> None:
    """Drop the program's state (and the files its trainer wrote)."""
    s.trainer = s.state = s.params = None
    shutil.rmtree(s.out_dir, ignore_errors=True)
    s.probe.trainer = None
    gc.collect()
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def program_train_readings(s: Session, w0: dict, R):
    """The program's first steps as the comparison reads them; the first
    gradient from Adam's first moment after step 1, mu = (1 - b1) (g +
    wd p0), with the constants of the reference ``R``."""
    p = s.probe
    names = list(w0)
    grad1 = {k: m.double() / (1 - R.ADAM_B1) - R.WEIGHT_DECAY * w0[k].double()
             for k, m in zip(names, p.mu1)}
    change = {k: p.params_last[k] - w0[k] for k in names}
    return R.TrainReadings([float(t) for _, _, t in p.first], grad1, change)


def train_check(s: Session, variants=("program",)) -> dict:
    """{variant: numbers} of the captured steps against the reference.
    Variants besides the program put the reference in its place: "tf32"
    computes it with TF32 on, "half" leaves half of each batch out."""
    spec, R = s.cell.config, s.cell.reference()
    prot = s.splits["train"]
    pad = s.cell.config["pad_id"]
    batches = [R.batch_of(prot, idx, shape[0], shape[1], pad, s.device)
               for idx, shape, _ in s.probe.first]
    w0 = s.cell.weights().make(spec, s.seed, _angle_means(s), s.device)
    ref = R.train_steps(spec, w0, batches, s.cell.traffic["run_seed"],
                        s.device)
    out = {}
    for v in variants:
        if v == "program":
            got = program_train_readings(s, w0, R)
        elif v == "tf32":
            with tf32(True):
                got = R.train_steps(spec, w0, batches,
                                    s.cell.traffic["run_seed"], s.device)
        elif v == "half":
            got = R.train_steps(spec, w0, batches,
                                s.cell.traffic["run_seed"], s.device,
                                drop_half=True)
        out[v] = correct.train_numbers(got, ref)
    return out


def eval_sample(s: Session, rec) -> list:
    """Positions in ``rec`` of the sampled batches: the longest batch of a
    random epoch and EVAL_SAMPLE - 1 others, drawn from the seed."""
    rng = np.random.default_rng(s.seed)
    lengths = [sh[1] for sh in rec.shapes]
    longest = [i for i, n in enumerate(lengths) if n == max(lengths)]
    first = int(rng.choice(longest))
    rest = [i for i in range(len(lengths)) if i != first]
    k = min(EVAL_SAMPLE - 1, len(rest))
    return [first] + [int(i) for i in rng.choice(rest, k, replace=False)]


def eval_check(s: Session, rec, variants=("program",)) -> dict:
    spec, R = s.cell.config, s.cell.reference()
    prot = s.splits[s.cell.traffic["eval_split"]]
    pad = s.cell.config["pad_id"]
    picks = eval_sample(s, rec)
    rows = torch.stack([rec.outputs[i] for i in picks]).double().cpu()
    prog = [[float(r[METRIC_KEYS.index(k)]) for k in R.METRICS]
            for r in rows]
    batches = [R.batch_of(prot, rec.indices[i], rec.shapes[i][0],
                          rec.shapes[i][1], pad, s.device) for i in picks]
    w0 = s.cell.weights().make(spec, s.seed, _angle_means(s), s.device)
    ref = R.score(spec, w0, batches, s.device)
    out = {}
    for v in variants:
        if v == "program":
            got = prog
        elif v == "tf32":
            with tf32(True):
                got = R.score(spec, w0, batches, s.device)
        elif v == "half":
            got = R.score(spec, w0, batches, s.device, drop_half=True)
        out[v] = correct.eval_numbers(got, ref, list(R.METRICS))
    return out


def _angle_means(s: Session):
    t = s.splits["train"]
    real = np.arange(t.sincos.shape[1])[None, :] < t.lens[:, None]
    return t.sincos[real].mean(0)


def set_precision(config: dict) -> None:
    """TF32 for matrix products and cuDNN as the configuration's ``tf32``
    states."""
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for matrix products and cuDNN inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------- metrics


def end_to_end(cell, rec, setup_s: float) -> dict:
    vals = {"setup_s": setup_s}
    if rec.kind == "train":
        vals["train_res_per_s"] = rec.n_res / rec.seconds
        vals["train_step_ms_p95"] = float(np.percentile(rec.periods_ms(), 95))
    else:
        vals["eval_res_per_s"] = rec.n_res / rec.seconds
    return {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end()}


@dataclasses.dataclass
class RunData:
    """What a per-layer reader reads."""
    config: dict
    kind: str
    stretch: object
    traced: dict | None
    n_params: int
    device_name: str
    on_card: bool
