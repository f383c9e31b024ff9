"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (traceback, non-zero exit, no result line):

1. device: card name, torch and CUDA versions, nvidia-smi name and power
   limit;
2. build: compiles the three kernel libraries from this checkout at once,
   one nvcc each: csrc/drmsd_fwd.cu (K1a), csrc/drmsd_train.cu (K1b, K1c)
   and csrc/sidechain.cu (K2a, K2b);
3. kernels against their plain PyTorch versions on the card.
   dRMSD (K1a, K1b, K1c), ~70% of atoms valid and one protein all masked,
   at B=8 x N = 600, 768, 3584, 7000 and at the training step's B=16 x
   N = 768, 3584: equal pair counts, |d dRMSD| <= 1e-4 A, K1b's S equal to
   K1a's bit for bit, gradients (K1b: dS/da, K1c: dS/db) within
   1e-4 * max(1, max|g|), zero statistic and gradient for the all-masked
   protein, the same bits on a second call.
   Sidechain build (K2a, K2b) at (B, L) = (8, 256), (16, 256), (8, 500),
   (3, 37), (1, 1), all 20 amino acids and padding in the batch, on
   full-range and on physical angles: dead slots exactly zero; everything
   finite, padded rows and their gradients included; the kernel's
   distance from a float64 plain build at most twice the fp32 plain
   build's plus 1e-5 A (on full-range angles nearly collinear frames
   amplify any rounding); on physical angles the kernel within 1e-4 A of
   the float64 build, and of the fp32 plain build up to that one's own
   distance from it;
   the gradients of sum(sin(0.3 crd)) with respect to backbone, anchor and
   torsions within 1e-4 * max(1, max|g|) of autograd through plain; the
   same bits on a second call.
   Median times of kernel and plain over 25 runs (CUDA events), and each
   kernel's bound: the larger of its bytes (inputs read once, outputs
   written once) over 3.35 TB/s and its operations on this run's data over
   67 TFLOP/s (fp32 outside the tensor cores);
4. goldens on the card: NeRF coordinates (tests/golden/coords.npz,
   realistic_coords.npz) <= 1e-3 A, and the conv-enc model forward
   (tests/golden/model_parity_conv-enc.npz) <= 2e-5 with TF32 off;
5. the eval slice at the flagship width, conv-enc|21,11,3|1,1,1 (d_model
   512, d_ff 2048, 8 heads, 6 layers), B=8 x L=256, random seeded weights:
   ``Trainer.eval_epoch`` over 2 batches in three arms, interleaved: every
   kernel on, the dRMSD kernels on with the plain sidechain build, and all
   plain; metrics finite and equal to the all-plain arm's within 1e-4
   (dRMSD family, RMSD) and 1e-6 (MSE); ms per eval step and residues/s of
   each arm; per step K1a launched twice, K2a once, K2b never;
6. the training slice at the same width (combined loss, Adam, Noam,
   coupled weight decay, clip 1.0, dropout 0.1), residue-budget batches of
   15 proteins of length 255-256 padded to B=16 x L=256:
   ``Trainer.train_epoch`` over 9 steps in the same three arms; finite
   losses; per step K1b launched twice, K2a and K2b once, K1a and K1c
   never; ms per step and residues/s from interleaved epochs; and at
   dropout 0 from identical weights, one step's loss (within 1e-4
   relative) and every parameter's gradient (within 1e-3 of its largest
   entry) of the all-kernels path against the all-plain path. Phases 5
   and 6 also count each arm's device operations and device time per step
   with torch.profiler;
7. the training CLI at the same width: a synthetic dataset (train, two
   validation splits, test; lengths 255-256) written with torch.save, then
   ``training.cli.main`` for two epochs into a temporary run directory:
   finite epoch metrics for train and each validation split, test
   evaluated, checkpoints/best with its sidecar, the .train CSV with its
   rows, config.json, and the kernels launched as often as the steps say;
   the checkpoint restored bit for bit; then ``main`` again with -e 3 on
   the same directory, which must resume from 'best' at epoch 2 and
   finish. Prints ms per train step and residues/s of the second epoch.

It prints the kernel table as one JSON line, and as its last line
{"ok": true, "device": {...}}. It needs one CUDA device and no network.
"""
from __future__ import annotations

import contextlib
import csv
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.dataset import collate
from protein_transformer_tpu_torch.data.dataset import DataModule
from protein_transformer_tpu_torch.data.synthetic import (
    make_dataset, sidechain_case)
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.models.conv_encoder import (
    ConvEncoderOnlyTransformer)
from protein_transformer_tpu_torch.models.flax_import import (
    load_flax_params, params_from_flat_keys)
from protein_transformer_tpu_torch.ops import _build
from protein_transformer_tpu_torch.ops import drmsd as D
from protein_transformer_tpu_torch.ops import sidechain as S
from protein_transformer_tpu_torch.protein import geometry as G
from protein_transformer_tpu_torch.protein.geometry import build_coords_batch
from protein_transformer_tpu_torch.training import cli
from protein_transformer_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
LIBRARIES = ("drmsd_fwd", "drmsd_train", "sidechain")
# (B, N): the sizes of the TPU kernel's tests, then the training step's
# full-atom (14 x 256) and backbone (3 x 256) sweeps at B=16
KERNEL_CASES = ((8, 600), (8, 768), (8, 3584), (8, 7000), (16, 768),
                (16, 3584))
EVAL_CASE = (8, 3584)    # the eval step's full-atom sweep
TRAIN_CASE = (16, 3584)  # the train step's full-atom sweep
# (B, L) of the sidechain kernels: the eval and train steps' batches, the
# longest proteins, and the small sizes of the TPU kernel's tests
SIDECHAIN_CASES = ((8, 256), (16, 256), (8, 500), (3, 37), (1, 1))
SIDECHAIN_TRAIN_CASE = (16, 256)
TIMED_RUNS = 25
TRAIN_REPEAT = 8         # 16 proteins x 8 / (8 x 500 residues) -> 9 steps
MODEL = "conv-enc|21,11,3|1,1,1"
# arm -> (drmsd_impl, sidechain_impl)
ARMS = {"all": ("cuda", "cuda"), "drmsd": ("cuda", "torch"),
        "plain": ("torch", "torch")}

# The card's peaks for the bounds: HBM bytes/s and fp32 FLOP/s outside the
# tensor cores (NVIDIA's H100 SXM data sheet).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# fp32 operations per valid pair i < j. K1a: per distance 3 subtractions, 5
# for the squared norm, max, rsqrt, a product (11), twice; the difference and
# its squared accumulation (3). K1b adds coef = 2 delta / Da (2), coef * diff
# (3) and the two accumulations per component (6). K1c needs both distances
# and their difference (23), then the same 11 on b's differences.
FLOPS_PER_PAIR = {"drmsd_fwd": 25, "drmsd_fwd_grad": 36, "drmsd_grad_b": 34}
# fp32 operations per live sidechain slot. K2a: two differences (6), three
# normalisations (11 each), two cross products (18), two sincos and four
# products (8), the placement (18). K2b recomputes the frame and the offsets
# (65) and adds three normalisation cotangents (24 each), four cross
# products (36), the torsion cotangent (13) and the accumulations (~30).
FLOPS_PER_SLOT = {"sidechain_fwd": 83, "sidechain_bwd": 216}
# bytes per residue: K2a reads bb 48, anchor 12, torsions, lengths and angles
# 120, n_sc 4, frame indices 120 and writes 168; K2b reads the built points
# and their cotangent (336) with the same tables and anchor (256), and writes
# 48 + 12 + 40.
SIDECHAIN_BYTES = {"sidechain_fwd": 304 + 168, "sidechain_bwd": 592 + 100}


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


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time the card could take to
    move n_bytes and do flops fp32 operations, and which of the two it is."""
    t_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def profile_steps(fn, steps: int = 3) -> tuple[float, float]:
    """(device operations per call, device ms per call) of fn() from a
    torch.profiler trace of ``steps`` calls: every kernel, copy and memset
    the device ran."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    require(bool(on_device), "the profiler saw device operations")
    return (sum(e.count for e in on_device) / steps,
            sum(e.self_device_time_total for e in on_device) / 1e3 / steps)


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
    """All three dRMSD kernels against their plain versions on one (B, N)
    case; returns {kernel: (max abs error, kernel ms, plain ms, bound ms,
    what bounds it)}."""
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
    # bytes: a, b and the mask read once; S and C, or a gradient, written
    pairs = int(fc.sum())
    read = bsz * n * 25
    bounds = {"drmsd_fwd": bound(read + bsz * 12,
                                 FLOPS_PER_PAIR["drmsd_fwd"] * pairs),
              "drmsd_fwd_grad": bound(read + bsz * 12 + bsz * n * 12,
                                      FLOPS_PER_PAIR["drmsd_fwd_grad"]
                                      * pairs),
              "drmsd_grad_b": bound(read + bsz * n * 12,
                                    FLOPS_PER_PAIR["drmsd_grad_b"] * pairs)}
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
    out = {k: (*v, *bounds[k]) for k, v in out.items()}
    scale = float(pga.abs().max())
    print(f"[kernel] {where}: counts equal, K1b S == K1a S (bits), "
          f"|d dRMSD| {err:.3e} A, |d dS/da| {ga_err:.3e} (max|g| "
          f"{scale:.3e}), |d dS/db| {gb_err:.3e}; kernel vs plain ms: "
          + ", ".join(f"{k} {v[1]:.4f} vs {v[2]:.4f}"
                      for k, v in out.items())
          + f"; {pairs} valid pairs, bounds in ms: "
          + ", ".join(f"{k} {v[3]:.5f} by {v[4]}" for k, v in out.items())
          + f" (median of {TIMED_RUNS}; {card})")
    return out


def phase_kernel(dev, card):
    rng = np.random.default_rng(0)
    return {case: kernel_case(dev, card, rng, *case)
            for case in KERNEL_CASES}


def sidechain_grads(inputs, impl):
    """The build through ``impl`` from fresh leaves of bb, anchor and
    torsions; returns (coordinates, their gradients of sum(sin(0.3 crd)))."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs[:3]]
    crd = S.build_sidechain_points(*leaves, *inputs[3:], impl=impl)
    grads = torch.autograd.grad(torch.sin(0.3 * crd).sum(), leaves)
    return crd.detach(), grads


def sidechain_case_check(dev, rng, bsz, length, physical):
    """K2a and K2b against the plain version on one (B, L) case; returns
    (the inputs, max forward error, max gradient error)."""
    ang, ids = sidechain_case(rng, bsz, length, physical)
    where = (f"B={bsz} L={length} "
             f"{'physical' if physical else 'full-range'} angles")
    if bsz * length >= 60:
        require(set(range(21)) <= set(ids.ravel().tolist()),
                f"all 20 amino acids and padding in the batch, {where}")
    ang, ids = torch.from_numpy(ang).to(dev), torch.from_numpy(ids).to(dev)
    with torch.no_grad():
        bb = G.build_backbone(ang)
        inputs = [bb, *G.sidechain_inputs(bb, ang, ids)]
    got, k_grads = sidechain_grads(inputs, "cuda")
    want, p_grads = sidechain_grads(inputs, "torch")
    torch.cuda.synchronize()
    require(torch.isfinite(got).all().item()
            and all(torch.isfinite(g).all().item() for g in k_grads),
            f"values and gradients finite, padded rows included, {where}")
    dead = torch.arange(S.MAX_SC_ATOMS, device=dev) >= inputs[5][..., None]
    require(not got[:, :, 4:][dead].any().item()
            and torch.equal(got[:, :, :4], bb),
            f"dead slots exactly zero and the backbone passed through, "
            f"{where}")
    # The plain build in float64 on the same inputs is the yardstick: at
    # coordinates of hundreds of A one fp32 rounding is ~1e-5 A, and the fp32
    # plain build itself strays by several of them over its ten slots.
    err = float((got - want).abs().max())
    with torch.no_grad():
        exact = S.build_sidechain_points_torch(
            *(t.double() for t in inputs[:5]), *inputs[5:])
    k_far = float((got - exact).abs().max())
    p_far = float((want - exact).abs().max())
    require(k_far <= 2 * p_far + 1e-5,
            f"kernel {k_far:.3e} A from a float64 build, plain {p_far:.3e} "
            f"A: within twice plus 1e-5 A, {where}")
    if physical:
        require(k_far <= 1e-4 and err <= 1e-4 + p_far,
                f"kernel within 1e-4 A of the float64 build ({k_far:.3e}) "
                f"and of the fp32 plain build up to that one's own distance "
                f"({err:.3e} <= 1e-4 + {p_far:.3e}), {where}")
    g_err = max(grad_err(k, p, f"K2b d/d{name}, {where}") for name, k, p in
                zip(("bb", "anchor", "torsions"), k_grads, p_grads))
    got2, k_grads2 = sidechain_grads(inputs, "cuda")
    require(torch.equal(got2, got)
            and all(torch.equal(a, b) for a, b in zip(k_grads2, k_grads)),
            f"a second call gives the same bits, {where}")
    print(f"[kernel] sidechain {where}: |d coordinate| {err:.3e} A vs plain, "
          f"from a float64 plain build kernel {k_far:.3e} A and plain "
          f"{p_far:.3e} A, |d gradient| {g_err:.3e} (max|g| "
          f"{max(float(g.abs().max()) for g in p_grads):.3e}), dead slots "
          f"zero, same bits twice")
    return inputs, err, g_err


def sidechain_times(inputs, card):
    """{kernel: (kernel ms, plain ms, bound ms, what bounds it)} on one
    case's inputs, and the forward + backward pair through autograd."""
    ints = [t.to(torch.int32).contiguous() for t in inputs[5:]]
    leaves = [t.detach().clone().requires_grad_() for t in inputs[:3]]

    def fwd(impl):
        with torch.no_grad():
            return S.build_sidechain_points(*inputs, impl=impl)

    def fwd_bwd(impl):
        crd = S.build_sidechain_points(*leaves, *inputs[3:], impl=impl)
        return torch.autograd.grad(crd, leaves, g_out)

    built = fwd("cuda")
    g_out = torch.randn_like(built)
    plain_graph = S.build_sidechain_points(*leaves, *inputs[3:],
                                           impl="torch")
    n_res = inputs[5].numel()
    live = int(inputs[5].clamp(max=S.MAX_SC_ATOMS).sum())
    times = {
        "sidechain_fwd": (cuda_ms(lambda: fwd("cuda")),
                          cuda_ms(lambda: fwd("torch"))),
        "sidechain_bwd": (
            cuda_ms(lambda: S.sidechain_bwd_cuda(built, *inputs[1:5], *ints,
                                                 g_out)),
            cuda_ms(lambda: torch.autograd.grad(plain_graph, leaves, g_out,
                                                retain_graph=True)))}
    out = {k: (*v, *bound(SIDECHAIN_BYTES[k] * n_res,
                          FLOPS_PER_SLOT[k] * live))
           for k, v in times.items()}
    pair = (cuda_ms(lambda: fwd_bwd("cuda")), cuda_ms(lambda: fwd_bwd("torch")))
    shape = tuple(inputs[5].shape)
    print(f"[kernel] sidechain B={shape[0]} L={shape[1]}: kernel vs plain "
          f"ms: K2a {out['sidechain_fwd'][0]:.4f} vs "
          f"{out['sidechain_fwd'][1]:.4f}, K2b {out['sidechain_bwd'][0]:.4f} "
          f"vs {out['sidechain_bwd'][1]:.4f}, forward + backward through "
          f"autograd {pair[0]:.4f} vs {pair[1]:.4f}; {live} live slots in "
          f"{n_res} residues, bounds in ms: "
          + ", ".join(f"{k} {v[2]:.5f} by {v[3]}" for k, v in out.items())
          + f" (median of {TIMED_RUNS}; {card})")
    return out


def phase_sidechain_kernel(dev, card):
    """Returns ({case: {kernel: (kernel ms, plain ms, bound ms, bound by)}},
    {kernel: max abs error against plain}); the forward error is that on
    physical angles."""
    rng = np.random.default_rng(1)
    table, errs = {}, {"sidechain_fwd": 0.0, "sidechain_bwd": 0.0}
    for case in SIDECHAIN_CASES:
        _, _, g_full = sidechain_case_check(dev, rng, *case, physical=False)
        inputs, err, g_phys = sidechain_case_check(dev, rng, *case,
                                                   physical=True)
        errs["sidechain_fwd"] = max(errs["sidechain_fwd"], err)
        # a lone residue is anchored on its own C: a degenerate frame whose
        # gradients are ~1e23, held to the relative gate above only
        if case[1] > 1:
            errs["sidechain_bwd"] = max(errs["sidechain_bwd"], g_full,
                                        g_phys)
        table[case] = sidechain_times(inputs, card)
    return table, errs


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


def flagship(arm: str, out_dir: str, **kw) -> TrainConfig:
    drmsd_impl, sidechain_impl = ARMS[arm]
    return TrainConfig(model=MODEL, d_model=512, d_ff=2048, n_heads=8,
                       n_layers=6, loss="combined", bucket_sizes=(256,),
                       batch_size=8, drmsd_impl=drmsd_impl,
                       sidechain_impl=sidechain_impl, out_dir=out_dir,
                       name=arm, **kw)


def random_weights(trainer, dev):
    """Seeded fresh weights with a non-zero output head, so the trunk
    reaches the outputs."""
    gen = torch.Generator().manual_seed(0)
    params = trainer.init_params(gen)
    w = params["head.output_projection.weight"]
    params["head.output_projection.weight"] = (
        0.02 * torch.randn(w.shape, generator=gen)).to(dev)
    return params


COUNTERS = {"drmsd_fwd": D.drmsd_stats_cuda,
            "drmsd_fwd_grad": D.drmsd_stats_grad_cuda,
            "drmsd_grad_b": D.drmsd_grad_b_cuda,
            "sidechain_fwd": S.sidechain_fwd_cuda,
            "sidechain_bwd": S.sidechain_bwd_cuda}


def reset_launches() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def timed_epoch(trainer, params, split):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = dict(trainer.eval_epoch(params, split))
    torch.cuda.synchronize()
    return metrics, time.perf_counter() - t0


def phase_slice(dev, card, out_dir):
    split = "test"
    data = make_dataset(n_train=8, n_eval=16, min_len=255, max_len=256,
                        seed=0, device=dev)
    trainers = {arm: Trainer(flagship(arm, out_dir), device=dev, data=data)
                for arm in ARMS}
    params = random_weights(trainers["all"], dev)
    n_batches = sum(1 for _ in trainers["all"].dm.eval_index_batches(split))
    n_res = int(trainers["all"].dm.eval_splits[split].lens.sum())
    require(n_batches >= 2, "at least 2 eval batches")

    for tr in trainers.values():  # warm-up, every arm
        timed_epoch(tr, params, split)
    reset_launches()
    got, seconds = timed_epoch(trainers["all"], params, split)
    launches = read_launches()
    require(launches == {"drmsd_fwd": 2 * n_batches, "drmsd_fwd_grad": 0,
                         "drmsd_grad_b": 0, "sidechain_fwd": n_batches,
                         "sidechain_bwd": 0},
            f"eval launches {launches}: expected per step K1a twice and K2a "
            f"once for {n_batches} steps, no other kernel")
    times = {arm: [] for arm in ARMS}
    times["all"].append(seconds)
    metrics = {"all": got}
    for arm in ("drmsd", "plain", "plain", "drmsd", "all", "all", "drmsd",
                "plain"):
        metrics[arm], seconds = timed_epoch(trainers[arm], params, split)
        times[arm].append(seconds)

    keys = ("drmsd-full", "lndrmsd-full", "drmsd-bb", "lndrmsd-bb",
            "mse-full", "mse-bb", "mse-sc", "rmsd-full", "combined-full")
    for arm in ("all", "drmsd"):
        for key in keys:
            g = metrics[arm][f"epoch-{key}"]
            p = metrics["plain"][f"epoch-{key}"]
            # combined = 0.5 ln-dRMSD / 0.02 + 0.5 MSE / 0.01: 25x the ln
            # gate. With the plain sidechain build the coordinates are the
            # plain arm's own, and the RMSD agrees to 1e-6.
            tol = {"mse": 1e-6, "combined": 2.5e-3,
                   "rmsd": 1e-4 if arm == "all" else 1e-6}.get(
                       key.split("-")[0], 1e-4)
            require(np.isfinite(g) and np.isfinite(p), f"{key} finite")
            require(abs(g - p) <= tol, f"{key}: {arm} arm {g} vs plain {p} "
                                       f"within {tol}")
    require(got["epoch-drmsd-full"] > 0, "dRMSD is positive")
    print("[slice] metrics (all kernels): " + json.dumps(
        {k: got[f"epoch-{k}"] for k in keys}))
    cfg = trainers["all"].cfg
    steps = {arm: 1e3 * statistics.median(t) / n_batches
             for arm, t in times.items()}
    batch = next(trainers["all"].dm.eval_batches(split))
    for arm, tr in trainers.items():
        n_ops, dev_ms = profile_steps(lambda: tr.eval_step(params, batch))
        print(f"[profile] eval step, {arm}: {n_ops:.0f} device operations "
              f"and {dev_ms:.2f} ms of device time per step; idle share "
              f"{1 - dev_ms / steps[arm]:.2f} of the {steps[arm]:.2f} ms "
              f"step timed above ({card})")
    print(f"[slice] {MODEL}, d_model {cfg.d_model} x {cfg.n_layers} layers, "
          f"{n_batches} batches of B=8 x L=256, ms/step (res/s): "
          + ", ".join(f"{label} {steps[arm]:.2f} "
                      f"({1e3 * n_res / (steps[arm] * n_batches):.0f})"
                      for arm, label in (("all", "all kernels"),
                                         ("drmsd", "dRMSD kernels only"),
                                         ("plain", "all plain")))
          + f", medians of 3 epochs each, interleaved; launches in the "
          f"counted epoch {json.dumps(launches)} ({card})")
    return launches


TRAIN_EPOCH = Trainer.train_epoch  # phase 7 wraps the method to time it


def train_epoch_timed(trainer, state, logger=None):
    """One training epoch; returns (state, seconds, steps, residues)."""
    rng = np.random.default_rng(trainer.cfg.seed + state.step)
    batches = list(trainer.dm.train_index_batches(rng))
    n_res = int(sum(np.minimum(trainer.dm.train.lens[idx],
                               trainer.dm.max_seq_len).sum()
                    for idx in batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = TRAIN_EPOCH(trainer, state, logger)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    m = trainer.metrics["train"]
    for key in ("combined-full", "drmsd-full", "lndrmsd-full", "mse-full"):
        require(np.isfinite(m[f"epoch-{key}"]) and m[f"epoch-{key}"] > 0,
                f"train epoch-{key} finite and positive")
    return state, seconds, len(batches), n_res


def one_step_ab(dev, data, params, out_dir):
    """Loss and gradients of one step at dropout 0 from identical weights:
    the all-kernels path against the all-plain path."""
    results = []
    for arm in ("all", "plain"):
        tr = Trainer(flagship(arm, out_dir, dropout=0.0, max_seq_len=256),
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
            f"one-step loss: kernels {k_loss} vs plain {p_loss} within 1e-4 "
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
    print(f"[train] one step at dropout 0, same weights: loss all kernels "
          f"{k_loss:.6f} vs all plain {p_loss:.6f}; worst gradient error "
          f"{worst:.3e} of the parameter's largest entry")


def phase_train(dev, card, out_dir):
    data = make_dataset(n_train=16, n_eval=2, min_len=255, max_len=256,
                        seed=0, device=dev)
    kw = dict(optimizer="adam", lr_scheduling="noam", max_seq_len=256,
              repeat_train=TRAIN_REPEAT)
    trainers = {arm: Trainer(flagship(arm, out_dir, **kw), device=dev,
                             data=data) for arm in ARMS}
    params = random_weights(trainers["all"], dev)
    states = {arm: tr.state_from(params) for arm, tr in trainers.items()}
    for arm, tr in trainers.items():  # warm-up epoch, every arm
        states[arm] = train_epoch_timed(tr, states[arm])[0]

    reset_launches()
    states["all"], seconds, steps, n_res = train_epoch_timed(
        trainers["all"], states["all"])
    launches = read_launches()
    require(steps >= 8, f"{steps} training steps, expected at least 8")
    require(launches == {"drmsd_fwd": 0, "drmsd_fwd_grad": 2 * steps,
                         "drmsd_grad_b": 0, "sidechain_fwd": steps,
                         "sidechain_bwd": steps},
            f"training launches {launches}: expected per step K1b twice, "
            f"K2a and K2b once for {steps} steps, K1a and K1c none")
    times = {arm: [] for arm in ARMS}
    rates = {arm: [] for arm in ARMS}
    times["all"].append(seconds / steps)
    rates["all"].append(n_res / seconds)
    for arm in ("drmsd", "plain", "plain", "drmsd", "all", "all", "drmsd",
                "plain"):
        states[arm], sec, n, res = train_epoch_timed(trainers[arm],
                                                     states[arm])
        times[arm].append(sec / n)
        rates[arm].append(res / sec)
    batch_shape = next(trainers["all"].dm.train_batches(
        np.random.default_rng(0))).seq.shape
    m = trainers["all"].metrics["train"]
    print("[train] last epoch (all kernels): " + json.dumps(
        {k: m[f"epoch-{k}"] for k in ("combined-full", "drmsd-full",
                                      "lndrmsd-full", "mse-full")}))
    cfg = trainers["all"].cfg
    batch = next(trainers["all"].dm.train_batches(np.random.default_rng(0)))
    for arm, tr in trainers.items():
        def step(arm=arm, tr=tr):
            states[arm] = tr.train_step(states[arm], batch)[0]
        n_ops, dev_ms = profile_steps(step)
        ms = 1e3 * statistics.median(times[arm])
        print(f"[profile] train step, {arm}: {n_ops:.0f} device operations "
              f"and {dev_ms:.2f} ms of device time per step; idle share "
              f"{1 - dev_ms / ms:.2f} of the {ms:.2f} ms step timed above "
              f"({card})")
    print(f"[train] {MODEL}, d_model {cfg.d_model} x {cfg.n_layers} layers, "
          f"{steps} steps per epoch of B={batch_shape[0]} x "
          f"L={batch_shape[1]}, ms/step (res/s): "
          + ", ".join(f"{label} {1e3 * statistics.median(times[arm]):.2f} "
                      f"({statistics.median(rates[arm]):.0f})"
                      for arm, label in (("all", "all kernels"),
                                         ("drmsd", "dRMSD kernels only"),
                                         ("plain", "all plain")))
          + f", medians of 3 epochs each, interleaved; launches in the "
          f"counted epoch {json.dumps(launches)} ({card})")
    one_step_ab(dev, data, params, out_dir)
    return launches


def run_cli(argv):
    """``cli.main(argv)`` with its standard output echoed and returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    print(buf.getvalue(), end="")
    return buf.getvalue()


def phase_cli(dev, card, out_dir):
    """The training CLI for two epochs and a resumed third."""
    data = make_dataset(n_train=16, n_eval=8, min_len=255, max_len=256,
                        seed=0, device=dev)
    valid = ("valid-10", "valid-90")
    for split in [k for k in data if k.startswith("valid-")]:
        if split not in valid:
            del data[split]
    data_path = os.path.join(out_dir, "synthetic.pt")
    torch.save(data, data_path)
    argv = ["--data", data_path, "--name", "cli", "--out_dir", out_dir,
            "-m", MODEL, "-dm", "512", "-dih", "2048", "-nh", "8", "-nl", "6",
            "-do", "0.1", "-l", "combined", "-opt", "adam",
            "--lr_scheduling", "noam", "-b", "8", "--repeat_train",
            str(TRAIN_REPEAT), "--cluster", "True"]
    cfg = cli.config_from_args(argv)
    dm = DataModule(data, cfg)
    steps = len(list(dm.train_index_batches(np.random.default_rng(0))))
    eval_steps = {s: len(list(dm.eval_index_batches(s)))
                  for s in dm.eval_splits}
    require(set(eval_steps) == {*valid, "test"}, "two validation splits "
                                                 "and test")

    # time each train epoch of the CLI's trainer from the outside
    epochs = []

    def timed(self, state, logger=None):
        state, seconds, n, n_res = train_epoch_timed(self, state, logger)
        epochs.append((seconds, n, n_res))
        return state

    Trainer.train_epoch = timed
    try:
        reset_launches()
        out = run_cli(argv + ["-e", "2"])
        launches = read_launches()
    finally:
        Trainer.train_epoch = TRAIN_EPOCH
    n_eval = 2 * sum(eval_steps[s] for s in valid) + eval_steps["test"]
    expected = {"drmsd_fwd": 2 * n_eval, "drmsd_fwd_grad": 2 * 2 * steps,
                "drmsd_grad_b": 0, "sidechain_fwd": 2 * steps + n_eval,
                "sidechain_bwd": 2 * steps}
    require(launches == expected,
            f"CLI launches {launches}: expected {expected} for 2 epochs of "
            f"{steps} train steps and {n_eval} eval steps")
    require("[ Epoch 0 ]" in out and "[ Epoch 1 ]" in out
            and "(Test)" in out, "two epochs and the test split ran")

    run_dir = os.path.join(out_dir, "cli")
    best = os.path.join(run_dir, "checkpoints", "best")
    for path in (best, best + ".meta.json",
                 os.path.join(run_dir, "config.json")):
        require(os.path.isfile(path), f"{os.path.relpath(path, out_dir)} "
                                      "written")
    with open(os.path.join(run_dir, "cli.train")) as f:
        rows = list(csv.DictReader(f))
    epoch_rows = {r["mode"]: r for r in rows if r["granularity"] == "epoch"}
    require(set(epoch_rows) == {"train", *valid, "test"},
            f"epoch rows of train, {valid} and test in the CSV")
    for mode, r in epoch_rows.items():
        require(all(np.isfinite(float(r[k])) and float(r[k]) > 0
                    for k in ("drmsd", "ln_drmsd", "rmse", "combined")),
                f"finite epoch metrics for {mode}: {r}")
    n_batch_rows = sum(r["granularity"] == "batch" for r in rows)
    require(n_batch_rows == 2 * steps and len(rows) == 2 * steps + 7,
            f"{len(rows)} CSV rows, {n_batch_rows} of them train batches")

    # what a resuming run restores equals the checkpoint bit for bit
    with open(best + ".meta.json") as f:
        saved_epoch = json.load(f)["epoch"]
    saved = torch.load(best, weights_only=True, map_location=dev)
    tr = Trainer(cli.config_from_args(argv + ["-e", "3"]), device=dev)
    restored = tr.maybe_restore(
        tr.init_state(torch.Generator().manual_seed(1)))
    require(restored.step == saved["step"] == (saved_epoch + 1) * steps
            and tr.start_epoch == saved_epoch + 1,
            "the restored step and epoch are the checkpoint's")
    require(all(torch.equal(restored.params[k], saved["params"][k])
                for k in restored.params)
            and all(torch.equal(mu, saved["opt_state"]["mu"][k])
                    and torch.equal(nu, saved["opt_state"]["nu"][k])
                    for k, mu, nu in zip(restored.params,
                                         restored.opt_state.mu,
                                         restored.opt_state.nu)),
            "restored parameters and optimizer moments equal the "
            "checkpoint's bit for bit")
    del tr, restored, saved

    out = run_cli(argv + ["-e", "3"])
    first = saved_epoch + 1
    require(f"[Info] Resumed from 'best' at epoch {first}." in out,
            "the second run says it resumed from 'best'")
    require(f"[ Epoch {first} ]" in out and "[ Epoch 0 ]" not in out
            and "[ Epoch 2 ]" in out and "(Test)" in out,
            f"the resumed run starts at epoch {first} and finishes")
    seconds, n, n_res = epochs[1]
    print(f"[cli] {MODEL}, d_model 512 x 6 layers: 2 epochs of {steps} train "
          f"steps and {n_eval} eval steps, then resumed from 'best' (epoch "
          f"{saved_epoch}) for a third; second epoch {1e3 * seconds / n:.2f} "
          f"ms/train step, {n_res / seconds:.0f} res/s; launches of the "
          f"first run {json.dumps(launches)} ({card})")
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
    sc_table, sc_errs = phase_sidechain_kernel(dev, card)
    phase_goldens(dev)
    with tempfile.TemporaryDirectory() as out_dir:
        eval_launches = phase_slice(dev, card, out_dir)
        train_launches = phase_train(dev, card, out_dir)
        cli_launches = phase_cli(dev, card, out_dir)
    source = "protein_transformer_tpu_torch/csrc/"
    replaces = "protein_transformer_tpu/ops/"
    rows = []
    for name, src, line, case, launches in (
            ("drmsd_fwd", "drmsd_fwd.cu", 56, EVAL_CASE,
             eval_launches["drmsd_fwd"]),
            ("drmsd_fwd_grad", "drmsd_train.cu", 151, TRAIN_CASE,
             train_launches["drmsd_fwd_grad"]),
            ("drmsd_grad_b", "drmsd_train.cu", 87, TRAIN_CASE,
             train_launches["drmsd_grad_b"])):
        _, k_ms, p_ms, b_ms, b_by = table[case][name]
        rows.append({"name": name, "route": "cuda", "source": source + src,
                     "replaces": f"{replaces}drmsd_pallas.py:{line}",
                     "launches": launches,
                     "max_abs_err": max(t[name][0] for t in table.values()),
                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
    for name, line in (("sidechain_fwd", 104), ("sidechain_bwd", 136)):
        k_ms, p_ms, b_ms, b_by = sc_table[SIDECHAIN_TRAIN_CASE][name]
        rows.append({"name": name, "route": "cuda",
                     "source": source + "sidechain.cu",
                     "replaces": f"{replaces}sidechain_pallas.py:{line}",
                     "launches": cli_launches[name],
                     "max_abs_err": sc_errs[name], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
