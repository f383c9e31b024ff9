"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (traceback, non-zero exit, no result line):

1. device: card name, torch and CUDA versions, nvidia-smi name and power
   limit;
2. build: compiles both kernel libraries from this checkout at once, one
   nvcc each: csrc/drmsd_fwd.cu (K1a) and csrc/drmsd_train.cu (K1b, K1c);
3. kernels against their plain PyTorch versions on the card, ~70% of atoms
   valid and one protein all masked, at B=8 x N = 600, 768, 3584, 7000 and
   at the training step's B=16 x N = 768, 3584: equal pair counts,
   |d dRMSD| <= 1e-4 A, K1b's S equal to K1a's bit for bit, gradients
   (K1b: dS/da, K1c: dS/db) within 1e-4 * max(1, max|g|), zero statistic
   and gradient for the all-masked protein, the same bits on a second
   call, and median times of kernel and plain over 25 runs (CUDA events);
4. goldens on the card: NeRF coordinates (tests/golden/coords.npz,
   realistic_coords.npz) <= 1e-3 A, and the conv-enc model forward
   (tests/golden/model_parity_conv-enc.npz) <= 2e-5 with TF32 off;
5. the eval slice at the flagship width, conv-enc|21,11,3|1,1,1 (d_model
   512, d_ff 2048, 8 heads, 6 layers), B=8 x L=256, random seeded weights:
   ``Trainer.eval_epoch`` over 2 batches with the kernel, then with the
   plain version; metrics finite and equal within 1e-4 (dRMSD family) and
   1e-6 (MSE); ms per eval step and residues/s for both; K1a launched
   twice per step;
6. the training slice at the same width (combined loss, Adam, Noam,
   coupled weight decay, clip 1.0, dropout 0.1), residue-budget batches of
   15 proteins of length 255-256 padded to B=16 x L=256:
   ``Trainer.train_epoch`` over 9 steps with the kernels, then with the
   plain versions; finite losses; K1b launched twice per step and K1a, K1c
   never; ms per step and residues/s for both from interleaved epochs; and
   at dropout 0 from identical weights, one step's loss (within 1e-4
   relative) and every parameter's gradient (within 1e-3 of its largest
   entry) of the kernel path against the plain path.

It prints the kernel table as one JSON line, and as its last line
{"ok": true, "device": {...}}. It needs one CUDA device and no network.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.dataset import collate
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.models.conv_encoder import (
    ConvEncoderOnlyTransformer)
from protein_transformer_tpu_torch.models.flax_import import (
    load_flax_params, params_from_flat_keys)
from protein_transformer_tpu_torch.ops import _build
from protein_transformer_tpu_torch.ops import drmsd as D
from protein_transformer_tpu_torch.protein.geometry import build_coords_batch
from protein_transformer_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
LIBRARIES = ("drmsd_fwd", "drmsd_train")
# (B, N): the sizes of the TPU kernel's tests, then the training step's
# full-atom (14 x 256) and backbone (3 x 256) sweeps at B=16
KERNEL_CASES = ((8, 600), (8, 768), (8, 3584), (8, 7000), (16, 768),
                (16, 3584))
EVAL_CASE = (8, 3584)    # the eval step's full-atom sweep
TRAIN_CASE = (16, 3584)  # the train step's full-atom sweep
TIMED_RUNS = 25
TRAIN_REPEAT = 8         # 16 proteins x 8 / (8 x 500 residues) -> 9 steps


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median device time of fn() in ms, one CUDA event pair per run."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    dev = cuda_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(dev)}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}")
    print(smi)
    return dev, card


def phase_build():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        libs = list(pool.map(_build.build, LIBRARIES))
    for name in LIBRARIES:
        _build.load(name)
    print(f"[build] {', '.join(LIBRARIES)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s ("
          + ", ".join(os.path.relpath(lib, ROOT) for lib in libs) + ")")


def drmsd_from(s, c):
    return torch.sqrt(torch.clamp(s / c.clamp(min=1).to(s.dtype), min=1e-30))


def grad_err(got, want, what):
    """max |got - want|, held to 1e-4 * max(1, max|want|)."""
    err = float((got - want).abs().max())
    bound = 1e-4 * max(1.0, float(want.abs().max()))
    require(err <= bound, f"{what}: gradient error {err:.3e} <= {bound:.3e}")
    return err


def kernel_case(dev, card, rng, bsz, n):
    """All three kernels against their plain versions on one (B, N) case;
    returns {kernel: (max abs error, kernel ms, plain ms)}."""
    a, b = (torch.from_numpy(rng.normal(0, 10, (bsz, n, 3)).astype(
        np.float32)).to(dev) for _ in range(2))
    m = torch.from_numpy(rng.random((bsz, n)) < 0.7).to(dev)
    m[-1] = False  # an all-masked protein
    fs, fc = D.drmsd_stats_cuda(a, b, m)
    gs, gc, ga = D.drmsd_stats_grad_cuda(a, b, m)
    gb = D.drmsd_grad_b_cuda(a, b, m)
    ps, pc = D.drmsd_stats_torch(a, b, m)
    _, _, pga = D.drmsd_stats_grad_torch(a, b, m)
    pgb = D.drmsd_grad_b_torch(a, b, m)
    torch.cuda.synchronize()
    where = f"B={bsz} N={n}"
    require(torch.isfinite(fs).all().item(), f"K1a values finite, {where}")
    require(torch.equal(fc, pc) and torch.equal(gc, pc),
            f"pair counts equal, {where}")
    require(torch.equal(gs, fs), f"K1b's S has K1a's bits, {where}")
    require(int(fc[-1]) == 0 and float(fs[-1]) == 0.0
            and not ga[-1].any() and not gb[-1].any(),
            f"all-masked protein gives zero S, C and gradients, {where}")
    err = float((drmsd_from(fs, fc) - drmsd_from(ps, pc)).abs().max())
    require(err <= 1e-4, f"|d dRMSD| {err:.3e} <= 1e-4 A, {where}")
    ga_err = grad_err(ga, pga, f"K1b dS/da, {where}")
    gb_err = grad_err(gb, pgb, f"K1c dS/db, {where}")
    gs2, _, ga2 = D.drmsd_stats_grad_cuda(a, b, m)
    require(torch.equal(gs2, gs) and torch.equal(ga2, ga)
            and torch.equal(D.drmsd_grad_b_cuda(a, b, m), gb)
            and torch.equal(D.drmsd_stats_cuda(a, b, m)[0], fs),
            f"a second call gives the same bits, {where}")
    out = {
        "drmsd_fwd": (err, cuda_ms(lambda: D.drmsd_stats_cuda(a, b, m)),
                      cuda_ms(lambda: D.drmsd_stats_torch(a, b, m))),
        "drmsd_fwd_grad": (
            ga_err, cuda_ms(lambda: D.drmsd_stats_grad_cuda(a, b, m)),
            cuda_ms(lambda: D.drmsd_stats_grad_torch(a, b, m))),
        "drmsd_grad_b": (
            gb_err, cuda_ms(lambda: D.drmsd_grad_b_cuda(a, b, m)),
            cuda_ms(lambda: D.drmsd_grad_b_torch(a, b, m))),
    }
    scale = float(pga.abs().max())
    print(f"[kernel] {where}: counts equal, K1b S == K1a S (bits), "
          f"|d dRMSD| {err:.3e} A, |d dS/da| {ga_err:.3e} (max|g| "
          f"{scale:.3e}), |d dS/db| {gb_err:.3e}; kernel vs plain ms: "
          + ", ".join(f"{k} {v[1]:.4f} vs {v[2]:.4f}"
                      for k, v in out.items())
          + f" (median of {TIMED_RUNS}; {card})")
    return out


def phase_kernel(dev, card):
    rng = np.random.default_rng(0)
    return {case: kernel_case(dev, card, rng, *case)
            for case in KERNEL_CASES}


def phase_goldens(dev):
    for name in ("coords.npz", "realistic_coords.npz"):
        z = np.load(os.path.join(GOLDEN, name))
        with torch.no_grad():
            crd = build_coords_batch(
                torch.from_numpy(z["ang"])[None].to(dev),
                torch.from_numpy(z["ids"])[None].to(dev))[0].cpu().numpy()
        err = float(np.abs(crd - z["crd"]).max())
        require(err <= 1e-3, f"{name}: coordinate error {err:.3e} <= 1e-3 A")
        print(f"[golden] {name}: max coordinate error {err:.3e} A")
    z = np.load(os.path.join(GOLDEN, "model_parity_conv-enc.npz"))
    am = np.random.default_rng(1).uniform(-0.5, 0.5, 24).astype(np.float32)
    model = ConvEncoderOnlyTransformer(
        n_layers=2, n_heads=2, d_model=32, d_ff=64, max_len=12,
        vocab_size=22, angle_means=am, conv_kernel_sizes=(5, 3),
        conv_dim_reductions=(2.0, 2.0)).to(dev)
    load_flax_params(model, params_from_flat_keys(z))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(z["ids"]).to(dev)).cpu().numpy()
    err = float(np.abs(out - z["expected"]).max())
    require(np.allclose(out, z["expected"], atol=2e-5, rtol=1e-4),
            f"conv-enc golden forward within 2e-5 (max error {err:.3e})")
    print(f"[golden] model_parity_conv-enc.npz: max error {err:.3e}")


def flagship(impl: str, **kw) -> TrainConfig:
    return TrainConfig(model="conv-enc|21,11,3|1,1,1", d_model=512,
                       d_ff=2048, n_heads=8, n_layers=6, loss="combined",
                       bucket_sizes=(256,), batch_size=8, drmsd_impl=impl,
                       **kw)


def random_weights(trainer, dev):
    """Seeded fresh weights with a non-zero output head, so the trunk
    reaches the outputs."""
    gen = torch.Generator().manual_seed(0)
    params = trainer.init_params(gen)
    w = params["head.output_projection.weight"]
    params["head.output_projection.weight"] = (
        0.02 * torch.randn(w.shape, generator=gen)).to(dev)
    return params


def timed_epoch(trainer, params, split):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = dict(trainer.eval_epoch(params, split))
    torch.cuda.synchronize()
    return metrics, time.perf_counter() - t0


def phase_slice(dev, card):
    split = "test"
    data = make_dataset(n_train=8, n_eval=16, min_len=255, max_len=256,
                        seed=0, device=dev)
    kernel_tr = Trainer(flagship("cuda"), device=dev, data=data)
    plain_tr = Trainer(flagship("torch"), device=dev, data=data)
    params = random_weights(kernel_tr, dev)
    n_batches = sum(1 for _ in kernel_tr.dm.eval_index_batches(split))
    n_res = int(kernel_tr.dm.eval_splits[split].lens.sum())
    require(n_batches >= 2, "at least 2 eval batches")

    timed_epoch(kernel_tr, params, split)  # warm-up, both paths
    timed_epoch(plain_tr, params, split)
    D.drmsd_stats_cuda.launches = 0
    got, k_s = timed_epoch(kernel_tr, params, split)
    launches = D.drmsd_stats_cuda.launches
    want, p_s = timed_epoch(plain_tr, params, split)
    require(launches == 2 * n_batches,
            f"{launches} kernel launches, expected {2 * n_batches}")
    k_times, p_times = [k_s], [p_s]
    for _ in range(2):  # more samples, interleaved: plain, kernel, ...
        p_times.append(timed_epoch(plain_tr, params, split)[1])
        k_times.append(timed_epoch(kernel_tr, params, split)[1])

    keys = ("drmsd-full", "lndrmsd-full", "drmsd-bb", "lndrmsd-bb",
            "mse-full", "mse-bb", "mse-sc", "rmsd-full", "combined-full")
    for key in keys:
        g, p = got[f"epoch-{key}"], want[f"epoch-{key}"]
        # combined = 0.5 ln-dRMSD / 0.02 + 0.5 MSE / 0.01: 25x the ln gate
        tol = {"mse": 1e-6, "rmsd": 1e-6, "combined": 2.5e-3}.get(
            key.split("-")[0], 1e-4)
        require(np.isfinite(g) and np.isfinite(p), f"{key} finite")
        require(abs(g - p) <= tol, f"{key}: kernel {g} vs plain {p} "
                                   f"within {tol}")
    require(got["epoch-drmsd-full"] > 0, "dRMSD is positive")
    print("[slice] metrics (kernel): " + json.dumps(
        {k: got[f"epoch-{k}"] for k in keys}))
    k_step = 1e3 * statistics.median(k_times) / n_batches
    p_step = 1e3 * statistics.median(p_times) / n_batches
    cfg = kernel_tr.cfg
    print(f"[slice] conv-enc|21,11,3|1,1,1, d_model {cfg.d_model} x "
          f"{cfg.n_layers} layers, {n_batches} batches of B=8 x L=256: kernel {k_step:.2f} ms/step "
          f"({1e3 * n_res / (k_step * n_batches):.0f} res/s), plain "
          f"{p_step:.2f} ms/step ({1e3 * n_res / (p_step * n_batches):.0f} "
          f"res/s); {launches} kernel launches ({card})")
    return launches


def train_epoch_timed(trainer, state):
    """One training epoch; returns (state, seconds, steps, residues)."""
    rng = np.random.default_rng(trainer.cfg.seed + state.step)
    batches = list(trainer.dm.train_index_batches(rng))
    n_res = int(sum(np.minimum(trainer.dm.train.lens[idx],
                               trainer.dm.max_seq_len).sum()
                    for idx in batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.train_epoch(state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    m = trainer.metrics["train"]
    for key in ("combined-full", "drmsd-full", "lndrmsd-full", "mse-full"):
        require(np.isfinite(m[f"epoch-{key}"]) and m[f"epoch-{key}"] > 0,
                f"train epoch-{key} finite and positive")
    return state, seconds, len(batches), n_res


def one_step_ab(dev, data, params):
    """Loss and gradients of one step at dropout 0 from identical weights:
    the kernel path against the plain path."""
    results = []
    for impl in ("cuda", "torch"):
        tr = Trainer(flagship(impl, dropout=0.0, max_seq_len=256),
                     device=dev, data=data)
        state = tr.state_from(params)
        idx = next(tr.dm.train_index_batches(np.random.default_rng(0)))
        batch = collate(tr.dm.train, idx, tr.cfg.bucket_sizes,
                        tr.dm.max_seq_len).to(dev)
        loss, _, grads = tr.loss_and_grads(state.params, batch)
        results.append((float(loss.detach()),
                        dict(zip(state.params, grads))))
    (k_loss, k_grads), (p_loss, p_grads) = results
    require(np.isfinite(k_loss) and abs(k_loss - p_loss)
            <= 1e-4 * abs(p_loss),
            f"one-step loss: kernel {k_loss} vs plain {p_loss} within 1e-4 "
            "relative")
    top = max(float(g.abs().max()) for g in p_grads.values())
    worst = 0.0
    for name, pg in p_grads.items():
        kg = k_grads[name]
        require(torch.isfinite(kg).all().item(), f"{name} gradient finite")
        # the attention key bias has an exact gradient of zero: fp32 noise
        scale = max(float(pg.abs().max()), 1e-3 * top)
        err = float((kg - pg).abs().max())
        require(err <= 1e-3 * scale,
                f"{name} gradient: {err:.3e} <= 1e-3 * {scale:.3e}")
        worst = max(worst, err / scale)
    print(f"[train] one step at dropout 0, same weights: loss kernel "
          f"{k_loss:.6f} vs plain {p_loss:.6f}; worst gradient error "
          f"{worst:.3e} of the parameter's largest entry")


def phase_train(dev, card):
    data = make_dataset(n_train=16, n_eval=2, min_len=255, max_len=256,
                        seed=0, device=dev)
    kw = dict(optimizer="adam", lr_scheduling="noam", max_seq_len=256,
              repeat_train=TRAIN_REPEAT)
    trainers = {impl: Trainer(flagship(impl, **kw), device=dev, data=data)
                for impl in ("cuda", "torch")}
    params = random_weights(trainers["cuda"], dev)
    states = {impl: tr.state_from(params) for impl, tr in trainers.items()}
    for impl, tr in trainers.items():  # warm-up epoch, both paths
        states[impl] = train_epoch_timed(tr, states[impl])[0]

    D.drmsd_stats_cuda.launches = 0
    D.drmsd_stats_grad_cuda.launches = 0
    D.drmsd_grad_b_cuda.launches = 0
    states["cuda"], k_s, steps, n_res = train_epoch_timed(trainers["cuda"],
                                                          states["cuda"])
    launches = {"drmsd_fwd": D.drmsd_stats_cuda.launches,
                "drmsd_fwd_grad": D.drmsd_stats_grad_cuda.launches,
                "drmsd_grad_b": D.drmsd_grad_b_cuda.launches}
    require(steps >= 8, f"{steps} training steps, expected at least 8")
    require(launches == {"drmsd_fwd": 0, "drmsd_fwd_grad": 2 * steps,
                         "drmsd_grad_b": 0},
            f"training launches {launches}: expected K1b 2 per step for "
            f"{steps} steps, K1a and K1c none")
    times = {"cuda": [k_s / steps], "torch": []}
    rates = {"cuda": [n_res / k_s], "torch": []}
    for impl in ("torch", "torch", "cuda", "cuda", "torch"):
        states[impl], sec, n, res = train_epoch_timed(trainers[impl],
                                                      states[impl])
        times[impl].append(sec / n)
        rates[impl].append(res / sec)
    batch_shape = next(trainers["cuda"].dm.train_batches(
        np.random.default_rng(0))).seq.shape
    m = trainers["cuda"].metrics["train"]
    print("[train] last epoch (kernel): " + json.dumps(
        {k: m[f"epoch-{k}"] for k in ("combined-full", "drmsd-full",
                                      "lndrmsd-full", "mse-full")}))
    cfg = trainers["cuda"].cfg
    print(f"[train] conv-enc|21,11,3|1,1,1, d_model {cfg.d_model} x "
          f"{cfg.n_layers} layers, {steps} steps per epoch of "
          f"B={batch_shape[0]} x L={batch_shape[1]}: kernel "
          f"{1e3 * statistics.median(times['cuda']):.2f} ms/step "
          f"({statistics.median(rates['cuda']):.0f} res/s), plain "
          f"{1e3 * statistics.median(times['torch']):.2f} ms/step "
          f"({statistics.median(rates['torch']):.0f} res/s), medians of 3 "
          f"epochs each, interleaved; launches in the counted epoch "
          f"{json.dumps(launches)} ({card})")
    one_step_ab(dev, data, params)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke run "
              "needs one GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, card = phase_device()
    phase_build()
    table = phase_kernel(dev, card)
    phase_goldens(dev)
    eval_launches = phase_slice(dev, card)
    train_launches = phase_train(dev, card)
    source = "protein_transformer_tpu_torch/csrc/"
    replaces = "protein_transformer_tpu/ops/drmsd_pallas.py:"
    rows = []
    for name, src, line, case, launches in (
            ("drmsd_fwd", "drmsd_fwd.cu", 56, EVAL_CASE, eval_launches),
            ("drmsd_fwd_grad", "drmsd_train.cu", 151, TRAIN_CASE,
             train_launches["drmsd_fwd_grad"]),
            ("drmsd_grad_b", "drmsd_train.cu", 87, TRAIN_CASE,
             train_launches["drmsd_grad_b"])):
        _, k_ms, p_ms = table[case][name]
        rows.append({"name": name, "route": "cuda", "source": source + src,
                     "replaces": f"{replaces}{line}", "launches": launches,
                     "max_abs_err": max(t[name][0] for t in table.values()),
                     "ms": k_ms, "plain_ms": p_ms})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
