"""Device time, device operations and stream synchronisations of the
coordinate build (angles -> all-atom coordinates) on one GPU.

The port's counterpart of tools/bench_geometry.py. Times the port whose
``protein_transformer_tpu_torch`` this imports. Run as a script with another
checkout's root first on ``PYTHONPATH`` it times that checkout instead, so
that two versions can be compared in one run on one card:

* ``build_coords_batch`` forward (under ``no_grad``) and forward + backward
  (autograd to the angles) at (B, L) = (16, 256), the training step's
  batch, and (8, 500), the longest proteins, on seeded angles and
  sequences: device ms and device operations per call from a
  ``torch.profiler`` trace of five calls, the device ms of the sidechain
  kernels K2a and K2b alone (their records in the same trace, by name), ms
  per call by CUDA events (the host's work included) and the stream
  synchronisations of one call (``torch.cuda.set_sync_debug_mode("warn")``);
  then the wrappers of K2a and K2b called alone on the arguments the build
  hands them (whatever their signature in the checkout timed): ms by CUDA
  events, their host work included, and device ms;
* with ``--steps``, one flagship conv-enc eval step (B=8 x L=256) and train
  step (B=16 x L=256; combined loss, Adam, Noam, dropout 0.1) with every
  kernel, from random seeded weights: device operations, device ms and
  synchronisations per step.

    python -m protein_transformer_tpu_torch.tools.bench_geometry [--steps]
    PYTHONPATH=<other checkout> python <this file> [--steps]

Prints one line per measurement with the card's name and power limit, then
the results as one JSON object. Needs a CUDA device and raises without one.
"""
from __future__ import annotations

import argparse
import functools
import json
import tempfile
import warnings

import numpy as np
import torch

from protein_transformer_tpu_torch.config import TrainConfig
from protein_transformer_tpu_torch.data.synthetic import make_dataset
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.ops import sidechain as S
from protein_transformer_tpu_torch.protein import geometry as G
from protein_transformer_tpu_torch.protein.vocab import VOCAB
from protein_transformer_tpu_torch.tools.bench_drmsd_kernel import (
    card_label, device_ms, device_records, event_ms)
from protein_transformer_tpu_torch.training.trainer import Trainer

SHAPES = ((16, 256), (8, 500))
CALLS = 5
MODEL = "conv-enc|21,11,3|1,1,1"
# the kernels' names in a trace, and their wrappers in ops/sidechain.py
KERNELS = {"k2a": "sidechain_fwd", "k2b": "sidechain_bwd"}
WRAPPERS = {"k2a": "sidechain_fwd_cuda", "k2b": "sidechain_bwd_cuda"}


def geometry_inputs(bsz: int, length: int, seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(angles (B, L, 12) float32, seq (B, L) int64): phi, psi and omega
    and the six chi uniform in (-pi, pi), the three backbone bond angles
    near their physical values, amino acids uniform over the 20; every row
    but the first ends in a padded tail (pad id, zero angles) of up to a
    quarter of its length."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, (bsz, length, 12)).astype(np.float32)
    ang[..., 3:6] = rng.normal((1.94, 2.03, 2.13), 0.02, (bsz, length, 3))
    seq = rng.integers(0, 20, (bsz, length))
    n_real = rng.integers(length - length // 4, length + 1, bsz)
    n_real[0] = length
    pad = np.arange(length)[None, :] >= n_real[:, None]
    seq[pad] = VOCAB.pad_id
    ang[pad] = 0.0
    return ang, seq.astype(np.int64)


def sync_sites(fn) -> list[str]:
    """Where the stream synchronisations of one fn() call happen: the
    ``file:line`` of the Python line that made each, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them. The warnings
    of every thread are caught while fn() runs."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}" for w in caught
            if "synchronizing CUDA operation" in str(w.message)]


def sync_count(fn) -> int:
    """The stream synchronisations of one fn() call (see ``sync_sites``)."""
    return len(sync_sites(fn))


def profile(fn, calls: int = CALLS) -> dict:
    """Device ms and device operations per fn() call, and each sidechain
    kernel's device ms, from one trace; ms per call by CUDA events; the
    synchronisations of one call."""
    records = device_records(fn, calls)
    out = {"device_ms": sum(e.self_device_time_total for e in records)
           / 1e3 / calls,
           "device_ops": sum(e.count for e in records) / calls}
    for key, name in KERNELS.items():
        mine = [e for e in records if name in e.key]
        if mine:
            out[f"{key}_device_ms"] = sum(e.self_device_time_total
                                          for e in mine) / 1e3 / calls
    out["event_ms"] = event_ms(fn)
    out["syncs"] = sync_count(fn)
    return out


def wrapper_calls(fn) -> dict:
    """{kernel: (wrapper, its arguments)}: the first call that fn() makes to
    each sidechain kernel's wrapper, caught by replacing the wrappers in
    their module while fn() runs."""
    caught = {}

    def catching(key, wrapper):
        # with the wrapper's attributes: a wrapper counts its launches on the
        # function that its module's name holds, here this one
        @functools.wraps(wrapper)
        def call(*args):
            caught.setdefault(key, (wrapper, args))
            return wrapper(*args)
        return call

    originals = {key: getattr(S, name) for key, name in WRAPPERS.items()}
    try:
        for key, wrapper in originals.items():
            setattr(S, WRAPPERS[key], catching(key, wrapper))
        fn()
    finally:
        for key, wrapper in originals.items():
            setattr(S, WRAPPERS[key], wrapper)
    return caught


def build_profile(device, shape) -> dict:
    """``profile`` of the coordinate build's forward and forward + backward
    at one (B, L)."""
    ang, seq = (torch.from_numpy(a).to(device)
                for a in geometry_inputs(*shape))
    leaf = ang.clone().requires_grad_()

    def forward():
        with torch.no_grad():
            return G.build_coords_batch(ang, seq)

    def forward_backward():
        crd = G.build_coords_batch(leaf, seq)
        return torch.autograd.grad(torch.sin(0.3 * crd).sum(), leaf)

    out = {"forward": profile(forward),
           "forward_backward": profile(forward_backward)}
    for key, (wrapper, args) in wrapper_calls(forward_backward).items():
        out[f"{key}_wrapper"] = {
            "event_ms": event_ms(lambda: wrapper(*args)),
            "device_ms": device_ms(lambda: wrapper(*args))}
    return out


def step_profile(device, steps: int = 3) -> dict:
    """Device operations, device ms and synchronisations per flagship eval
    and train step with every kernel."""
    data = make_dataset(n_train=16, n_eval=8, min_len=255, max_len=256,
                        seed=0, device=device)
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = TrainConfig(
            model=MODEL, d_model=512, d_ff=2048, n_heads=8, n_layers=6,
            loss="combined", optimizer="adam", lr_scheduling="noam",
            bucket_sizes=(256,), batch_size=8, max_seq_len=256,
            repeat_train=8, drmsd_impl="cuda", sidechain_impl="cuda",
            log_structure_step=0, log_val_struct_step=0, out_dir=out_dir,
            name="bench-geometry")
        trainer = Trainer(cfg, device=device, data=data)
        gen = torch.Generator().manual_seed(0)
        params = trainer.init_params(gen)
        w = params["head.output_projection.weight"]
        params["head.output_projection.weight"] = (
            0.02 * torch.randn(w.shape, generator=gen)).to(device)
        state = trainer.state_from(params)
        batches = {"eval_step": next(trainer.dm.eval_batches("test")),
                   "train_step": next(trainer.dm.train_batches(
                       np.random.default_rng(0)))}

        def train_step():
            nonlocal state
            state = trainer.train_step(state, batches["train_step"])[0]

        fns = {"eval_step": lambda: trainer.eval_step(params,
                                                      batches["eval_step"]),
               "train_step": train_step}
        out = {}
        for name, fn in fns.items():
            records = device_records(fn, steps)
            out[name] = {
                "batch": list(batches[name].seq.shape),
                "device_ops": sum(e.count for e in records) / steps,
                "device_ms": sum(e.self_device_time_total
                                 for e in records) / 1e3 / steps,
                "syncs": sync_count(fn)}
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", action="store_true",
                        help="also profile one flagship eval and train step")
    args = parser.parse_args(argv)
    device = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_label()
    print(f"# port at {G.__file__}")
    results = {"card": card, "build": {}}
    for shape in SHAPES:
        t = build_profile(device, shape)
        results["build"]["x".join(map(str, shape))] = t
        for name in ("forward", "forward_backward"):
            r = t[name]
            kernels = ", ".join(f"{k.upper()} {r[f'{k}_device_ms']:.4f} ms"
                                for k in KERNELS if f"{k}_device_ms" in r)
            print(f"build_coords_batch {name}, B={shape[0]} L={shape[1]}: "
                  f"{r['device_ms']:.4f} device ms ({kernels}), "
                  f"{r['device_ops']:.1f} device operations, "
                  f"{r['event_ms']:.4f} ms by events, {r['syncs']} "
                  f"synchronisations a call ({card})")
        print(f"wrappers alone, B={shape[0]} L={shape[1]}: " + ", ".join(
            f"{k.upper()} {t[f'{k}_wrapper']['event_ms']:.4f} ms by events, "
            f"{t[f'{k}_wrapper']['device_ms']:.4f} on the device"
            for k in KERNELS if f"{k}_wrapper" in t) + f" ({card})")
    if args.steps:
        results["steps"] = step_profile(device)
        for name, r in results["steps"].items():
            print(f"{name}, B x L = {r['batch']}: {r['device_ops']:.1f} "
                  f"device operations, {r['device_ms']:.3f} ms of device "
                  f"time, {r['syncs']} synchronisations per step ({card})")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
