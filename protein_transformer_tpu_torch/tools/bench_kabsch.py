"""Device time of the superposition RMSD: the Kabsch kernel (K5) beside the
tensor path with its SVD, on one GPU.

At the scoring step's batches, B = 32 proteins of L = 500 residues full-atom
(N = 14 L = 7,000) and backbone (N = 3 L = 1,500), seeded random walks and
their noisy rotated copies with 2% of the atoms missing:

* each path's largest relative and absolute gap to the tensor path run in
  float64 on the same card inputs, and the kernel's to the float32 tensor
  path;
* ms per call by CUDA events (the host's work included), device ms from a
  ``torch.profiler`` trace of five calls, device operations per call, the
  kernel's launches in one call and the stream synchronisations of one
  call, for both paths;
* the kernel's bound: its bytes, B N (24 + the mask's bytes), over
  3.35 TB/s.

    python -m protein_transformer_tpu_torch.tools.bench_kabsch

Prints one line per shape and path with the card's name and power limit,
then the results as one JSON line. Needs a CUDA device and raises without
one.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from protein_transformer_tpu_torch import losses as L
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.ops import kabsch as K
from protein_transformer_tpu_torch.tools.bench_drmsd_kernel import (
    card_label, device_ms, device_records, event_ms)
from protein_transformer_tpu_torch.tools.bench_geometry import sync_sites

# (B, N): the scoring step's full-atom and backbone batches
SHAPES = ((32, 7000), (32, 1500))
CALLS = 5
PEAK_BYTES_PER_S = 3.35e12


def inputs(bsz: int, n: int, seed: int = 0):
    """(pred, true) (B, N, 3) float32 and a (B, N) bool mask, in numpy."""
    rng = np.random.default_rng(seed)
    true = np.cumsum(rng.normal(0, 1.5, (bsz, n, 3)), axis=1)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pred = true @ q.T + rng.normal(0, 3.0, true.shape)
    return (pred.astype(np.float32), true.astype(np.float32),
            rng.random((bsz, n)) > 0.02)


def bound_ms(bsz: int, n: int, mask_bytes: int = 1) -> float:
    """The kernel's floor: its points and mask read once from HBM."""
    return bsz * n * (24 + mask_bytes) / PEAK_BYTES_PER_S * 1e3


def gaps(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Largest relative and absolute distance of got from want."""
    diff = (got.double() - want.double()).abs()
    return {"rel": float((diff / want.double().abs()).max()),
            "abs": float(diff.max())}


def main() -> dict:
    device = cuda_device()
    card = card_label()
    results = {}
    for bsz, n in SHAPES:
        a, b, w = (torch.from_numpy(x).to(device)
                   for x in inputs(bsz, n, seed=n))
        with torch.inference_mode():
            exact = L.kabsch_rmsd_masked(a.double(), b.double(), w,
                                         impl="torch")
            plain = L.kabsch_rmsd_masked(a, b, w, impl="torch")
        row = {"bound_ms": bound_ms(bsz, n), "bound_by": "bytes"}
        for impl in ("cuda", "torch"):
            def call(impl=impl):
                with torch.inference_mode():
                    return L.kabsch_rmsd_masked(a, b, w, impl=impl)
            launches = K.kabsch_rmsd_cuda.launches
            got = call()
            launches = K.kabsch_rmsd_cuda.launches - launches
            n_ops = sum(e.count for e in device_records(call, CALLS)) / CALLS
            row[impl] = {
                "gap_fp64": gaps(got, exact), "gap_plain": gaps(got, plain),
                "launches": launches,
                "ms": event_ms(call), "device_ms": device_ms(call, CALLS),
                "device_ops": n_ops, "syncs": len(sync_sites(call))}
            print(f"B={bsz} x N={n} {impl}: " + json.dumps(row[impl])
                  + f" bound {row['bound_ms']:.5f} ms ({card})")
        results[f"{bsz}x{n}"] = row
    results["card"] = card
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
