"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (traceback, non-zero exit, no result line):

1. device: card name, torch and CUDA versions, nvidia-smi name and power
   limit;
2. build: compiles the dRMSD kernel (csrc/drmsd_fwd.cu) from this checkout;
3. kernel against its plain PyTorch version on the card, B=8 proteins at
   N = 600, 768, 3584, 7000 atoms (one protein all masked): |d dRMSD| <=
   1e-4 A, equal pair counts, finite values, and median times of both over
   25 runs (CUDA events);
4. goldens on the card: NeRF coordinates (tests/golden/coords.npz,
   realistic_coords.npz) <= 1e-3 A, and the conv-enc model forward
   (tests/golden/model_parity_conv-enc.npz) <= 2e-5 with TF32 off;
5. the eval slice at the flagship width, conv-enc|21,11,3|1,1,1 (d_model
   512, d_ff 2048, 8 heads, 6 layers), B=8 x L=256, random seeded weights:
   ``Trainer.eval_epoch`` over 2 batches with the kernel, then with the
   plain version; metrics finite and equal within 1e-4 (dRMSD family) and
   1e-6 (MSE); ms per eval step and residues/s for both.

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

import numpy as np
import torch

from protein_transformer_tpu_torch.config import TrainConfig
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
KERNEL_NS = (600, 768, 3584, 7000)
MAIN_PATH_N = 3584  # the full-atom sweep at L=256; the backbone one is 768
TIMED_RUNS = 25


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
    lib = _build.build("drmsd_fwd")
    _build.load("drmsd_fwd")
    print(f"[build] drmsd_fwd built and loaded in "
          f"{time.perf_counter() - t0:.2f} s ({os.path.relpath(lib, ROOT)})")


def drmsd_from(s, c):
    return torch.sqrt(torch.clamp(s / c.clamp(min=1).to(s.dtype), min=1e-30))


def phase_kernel(dev, card):
    rng = np.random.default_rng(0)
    table = {}
    for n in KERNEL_NS:
        bsz = 8
        a = torch.from_numpy(rng.normal(0, 10, (bsz, n, 3)).astype(
            np.float32)).to(dev)
        b = torch.from_numpy(rng.normal(0, 10, (bsz, n, 3)).astype(
            np.float32)).to(dev)
        m = torch.from_numpy(rng.random((bsz, n)) < 0.7).to(dev)
        m[-1] = False  # an all-masked protein
        ks, kc = D.drmsd_stats_cuda(a, b, m)
        ps, pc = D.drmsd_stats_torch(a, b, m)
        torch.cuda.synchronize()
        require(torch.isfinite(ks).all().item(), f"kernel values finite, N={n}")
        require(torch.equal(kc, pc), f"pair counts equal, N={n}")
        require(int(kc[-1]) == 0 and float(ks[-1]) == 0.0,
                f"all-masked protein gives (0, 0), N={n}")
        err = float((drmsd_from(ks, kc) - drmsd_from(ps, pc)).abs().max())
        require(err <= 1e-4, f"|d dRMSD| {err:.3e} <= 1e-4 A at N={n}")
        k_ms = cuda_ms(lambda: D.drmsd_stats_cuda(a, b, m))
        p_ms = cuda_ms(lambda: D.drmsd_stats_torch(a, b, m))
        table[n] = (err, k_ms, p_ms)
        print(f"[kernel] B={bsz} N={n}: |d dRMSD| max {err:.3e} A, counts "
              f"equal; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"(median of {TIMED_RUNS}; {card})")
    return table


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


def flagship(impl: str) -> TrainConfig:
    return TrainConfig(model="conv-enc|21,11,3|1,1,1", d_model=512,
                       d_ff=2048, n_heads=8, n_layers=6, loss="combined",
                       bucket_sizes=(256,), batch_size=8, drmsd_impl=impl)


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
    gen = torch.Generator().manual_seed(0)
    params = kernel_tr.init_params(gen)
    w = params["head.output_projection.weight"]
    params["head.output_projection.weight"] = (
        0.02 * torch.randn(w.shape, generator=gen)).to(dev)
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
    launches = phase_slice(dev, card)
    _, k_ms, p_ms = table[MAIN_PATH_N]
    print(json.dumps({"kernels": [{
        "name": "drmsd_fwd",
        "route": "cuda",
        "source": "protein_transformer_tpu_torch/csrc/drmsd_fwd.cu",
        "replaces": "protein_transformer_tpu/ops/drmsd_pallas.py:56",
        "launches": launches,
        "max_abs_err": max(e for e, _, _ in table.values()),
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
