"""Parity check and microbenchmark of the dRMSD kernel variants.

Port of the JAX package's ``tools/bench_drmsd_kernel.py``: runs the
production kernels (``ops/drmsd.py``: K1a forward, K1b forward with dS/da)
beside the candidate rewrites of ``ops/drmsd_variants.py`` on one GPU, to
decide kernel changes by measurement:

  cur   : difference-form distances, two rsqrt a pair;
  sqrt1 : (Da - Db)^2 = d2a + d2b - 2 sqrt(d2a d2b), one square root a pair;
  mxu   : distances from the norm + cross-term form, the 3-deep cross term
          and the gradient's coef . x products on the tensor cores.

``parity`` holds the variants to the production kernels on one protein of
700 atoms (a ~ N(0, 30), b = a + N(0, 1), ~80% of atoms valid): S within 1e-5
relative and equal pair counts for sqrt1 and mxu, dS/da of mxu within
1e-4 * max(1, max|g|). ``bench`` prints, for (L, B) = (256, 8) and (500, 8)
(N = 14 L atoms, ~90% valid), the forward time of cur, sqrt1 and mxu and the
gradient time of cur (K1b: S, C and dS/da in one sweep) and mxu, twice: in
ms by CUDA events, median of 25 runs, which at these sizes holds the
wrapper's host work and moves with the host, and the device's own time for
one call, from a ``torch.profiler`` trace, which is what ranks the kernels.
The card's name and power limit stand on every line.

It times the port whose ``protein_transformer_tpu_torch`` it imports. Run
as a script with another checkout's root first on ``PYTHONPATH`` it times
that checkout's kernels instead, so that two versions can be compared in one
run on one card; on the GPU it ends with the times as one JSON object.

``--save-outputs FILE`` and ``--compare-outputs FILE`` replace the bench:
``outputs`` runs K1a, K1b, K1c, K4a, K4b and K4c on the bench's inputs at
both shapes and on the training step's masks at B=16 x 3584 atoms; the
first saves what they return, the second holds this checkout's against a
saved file bit for bit (``torch.equal``) and prints which kernels agree. Run
with two checkouts in turn, it shows whether a change kept a kernel's bits.

    python -m protein_transformer_tpu_torch.tools.bench_drmsd_kernel
    python -m protein_transformer_tpu_torch.tools.bench_drmsd_kernel \
        --device cpu
    PYTHONPATH=<other checkout> python <this file>
    PYTHONPATH=<other checkout> python <this file> --save-outputs other.pt
    python -m protein_transformer_tpu_torch.tools.bench_drmsd_kernel \
        --compare-outputs other.pt

The default device is the GPU, and the run raises without one. ``--device
cpu`` runs ``parity`` on the plain PyTorch versions only, which checks their
arithmetic and gives no time.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess

import numpy as np
import torch

from protein_transformer_tpu_torch.data.synthetic import atom_mask_case
from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.ops import drmsd as D
from protein_transformer_tpu_torch.ops import drmsd_variants as V

SHAPES = ((256, 8), (500, 8))
TIMED_RUNS = 25
ATOMS_PER_RESIDUE = 14

# calls of each implementation (by its name in ``implementations``) that the
# last ``bench`` made: 3 warm-up, TIMED_RUNS timed, 1 + 5 traced at each
# shape, and 5 more for each trace that ``device_records`` took again
CALLS: collections.Counter = collections.Counter()


def implementations(device: torch.device) -> dict:
    """The kernels for a CUDA device, the plain versions for the CPU."""
    if device.type == "cuda":
        return {"cur": D.drmsd_stats_cuda, "sqrt1": V.drmsd_stats_sqrt1_cuda,
                "mxu": V.drmsd_stats_mxu_cuda,
                "grad cur": D.drmsd_stats_grad_cuda,
                "grad mxu": V.drmsd_grad_a_mxu_cuda}
    return {"cur": D.drmsd_stats_torch, "sqrt1": V.drmsd_stats_sqrt1_torch,
            "mxu": V.drmsd_stats_mxu_torch,
            "grad cur": D.drmsd_stats_grad_torch,
            "grad mxu": V.drmsd_grad_a_mxu_torch}


def case(device, shape, masked: float):
    """a ~ N(0, 30), b = a + N(0, 1) of ``shape`` + (3,), and a mask with
    the share ``masked`` of atoms off, from seed 0: the JAX tool's draws."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 30, (*shape, 3))
    b = a + rng.normal(0, 1, (*shape, 3))
    mask = rng.random(shape) > masked
    return (torch.from_numpy(a.astype(np.float32)).to(device),
            torch.from_numpy(b.astype(np.float32)).to(device),
            torch.from_numpy(mask).to(device))


def parity(device: torch.device) -> dict:
    """Hold the variants to the production implementations on ``device``
    (see the module's docstring); raises AssertionError past a gate. Returns
    {"sqrt1": relative S error, "mxu": the same, "grad mxu": max abs
    gradient error}."""
    impl = implementations(device)
    a, b, mask = case(device, (700,), masked=0.2)
    want_s, want_c = impl["cur"](a, b, mask)
    out = {}
    for name in ("sqrt1", "mxu"):
        s, c = impl[name](a, b, mask)
        rel = abs(float(s) - float(want_s)) / max(abs(float(want_s)), 1e-9)
        print(f"fwd {name}: s={float(s):.6f} want={float(want_s):.6f} "
              f"rel={rel:.2e} count_ok={int(c) == int(want_c)}")
        if not (rel < 1e-5 and int(c) == int(want_c)):
            raise AssertionError(f"fwd {name}: S off by {rel:.2e} relative "
                                 f"or counts differ ({int(c)} vs "
                                 f"{int(want_c)})")
        out[name] = rel
    want_g = impl["grad cur"](a, b, mask)[2]
    got_g = impl["grad mxu"](a, b, mask)
    scale = float(want_g.abs().max())
    err = float((want_g - got_g).abs().max())
    print(f"bwd mxu: maxerr={err:.3e} scale={scale:.3e} "
          f"rel={err / scale:.2e}")
    if not err < 1e-4 * max(scale, 1.0):
        raise AssertionError(f"bwd mxu: max error {err:.3e} at scale "
                             f"{scale:.3e}")
    out["grad mxu"] = err
    print("parity OK")
    return out


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def event_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median time of fn() in ms over ``runs``, one CUDA event pair each,
    after three warm-up calls."""
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


def traced(fn, calls: int, on_card: bool = True, **profile_kw):
    """(a ``torch.profiler`` profile of ``calls`` calls of fn(), the traces
    taken). On the card it records the CPU and CUDA activities, and a trace
    that comes back without its device records (seen once in ~20 traces on
    an H100 under torch 2.11) is taken again, up to three traces; off the
    card it records the CPU alone, once. ``profile_kw`` goes to
    ``profile``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    for traces in range(1, 4):
        if on_card:
            torch.cuda.synchronize()
        with profile(activities=activities, **profile_kw) as prof:
            for _ in range(calls):
                fn()
            if on_card:
                torch.cuda.synchronize()
        if not on_card or on_device(prof):
            return prof, traces
        if traces < 3:
            print(f"the trace of {calls} calls recorded no device "
                  f"operation; taking it again")
    raise RuntimeError("the profiler recorded no device operation")


def on_device(prof) -> list:
    """The device-side rows (kernels, copies, memsets, by name) of a
    profile's ``key_averages()``."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_records(fn, calls: int) -> list:
    """The device-side records of a trace of ``calls`` calls of fn(), after
    one warm-up call (``traced``: an empty trace is taken again)."""
    fn()
    return on_device(traced(fn, calls)[0])


def device_ms(fn, calls: int = 5) -> float:
    """Device time in ms of everything one fn() call puts on the device (a
    wrapper's kernels and the zero-fills of its outputs), from a trace of
    ``calls`` calls: what ``event_ms`` holds beside the wrapper's host work.
    Each kernel's mean time is counted as often as one call launches it, so
    a trace that lost the records of one call (seen on an H100 under torch
    2.11) gives the same answer."""
    return sum(e.self_device_time_total / e.count
               * max(1, round(e.count / calls))
               for e in device_records(fn, calls)) / 1e3


def bench(device: torch.device, shapes=SHAPES) -> dict:
    """Time the five kernels at each (L, B) of ``shapes``; returns
    {(L, B): {"fwd cur": (event ms, device ms), "fwd sqrt1": ..., "fwd mxu":
    ..., "bwd cur": ..., "bwd mxu": ...}}. A CUDA device only: a time taken
    on the CPU would say nothing of the kernels."""
    if device.type != "cuda":
        raise ValueError("bench times the CUDA kernels and needs a CUDA "
                         f"device; got {device}")
    impl = implementations(device)
    card = card_label()
    CALLS.clear()

    def call(name):
        CALLS[name] += 1
        impl[name](a, b, mask)

    out = {}
    for length, bsz in shapes:
        n = length * ATOMS_PER_RESIDUE
        a, b, mask = case(device, (bsz, n), masked=0.1)
        print(f"-- L={length} B={bsz} (N={n})")
        times = {}
        for label, name in (("fwd  cur  ", "cur"), ("fwd  sqrt1", "sqrt1"),
                            ("fwd  mxu  ", "mxu"), ("bwd  cur  ", "grad cur"),
                            ("bwd  mxu  ", "grad mxu")):
            ms = event_ms(lambda: call(name))
            on_device = device_ms(lambda: call(name))
            times[" ".join(label.split())] = (ms, on_device)
            print(f"  {label}: {ms:7.3f} ms by events (median of "
                  f"{TIMED_RUNS}), {on_device:7.3f} ms on the device  "
                  f"({card})")
        out[(length, bsz)] = times
    return out


def outputs(device: torch.device) -> dict:
    """{kernel: {case: its outputs}} of K1a ("cur"), K1b ("grad cur"), K1c
    ("grad b"), K4a, K4b and K4c on the bench's inputs at each of SHAPES and
    on the training step's masks (``atom_mask_case``, seed 0, a, b ~
    N(0, 10)) at B=16 x 3584 atoms, on the CPU."""
    impl = implementations(device)
    calls = {name: impl[name] for name in ("cur", "grad cur", "sqrt1", "mxu",
                                           "grad mxu")}
    calls["grad b"] = (D.drmsd_grad_b_cuda if device.type == "cuda"
                       else D.drmsd_grad_b_torch)
    cases = {f"L={length} B={bsz}": case(
        device, (bsz, length * ATOMS_PER_RESIDUE), masked=0.1)
        for length, bsz in SHAPES}
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.normal(0, 10, (16, 3584, 3)).astype(
        np.float32)).to(device) for _ in range(2))
    cases["train masks B=16 N=3584"] = (
        a, b, torch.from_numpy(atom_mask_case(rng, 16, 3584)).to(device))
    out = {}
    for name, fn in calls.items():
        out[name] = {}
        for where, inputs in cases.items():
            got = fn(*inputs)
            out[name][where] = [t.cpu() for t in (
                got if isinstance(got, tuple) else (got,))]
    return out


def compare_outputs(mine: dict, saved: dict) -> dict:
    """{kernel: whether every output of it, in every case, equals the saved
    one bit for bit}; prints one line per kernel."""
    if mine.keys() != saved.keys():
        raise ValueError(f"the saved outputs are of {sorted(saved)}, not "
                         f"{sorted(mine)}")
    same = {}
    for name, cases in mine.items():
        same[name] = all(
            len(got) == len(saved[name][where]) and all(
                torch.equal(x, y) for x, y in zip(got, saved[name][where]))
            for where, got in cases.items())
        print(f"{name}: {'the same bits' if same[name] else 'other bits'} "
              f"in {len(cases)} cases")
    return same


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda needs a GPU and raises without one; cpu runs "
                         "the parity check on the plain versions only")
    ap.add_argument("--parity", action="store_true",
                    help="on the GPU, run the parity check before the bench")
    ap.add_argument("--save-outputs", metavar="FILE",
                    help="instead of the bench, save the kernels' outputs "
                         "(torch.save)")
    ap.add_argument("--compare-outputs", metavar="FILE",
                    help="instead of the bench, hold the kernels' outputs "
                         "against a saved file bit for bit")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        return {"parity": parity(torch.device("cpu"))}
    device = cuda_device()
    print(f"# port at {V.__file__}")
    out = {}
    if args.parity:
        out["parity"] = parity(device)
    if args.save_outputs or args.compare_outputs:
        mine = outputs(device)
        if args.save_outputs:
            torch.save(mine, args.save_outputs)
        if args.compare_outputs:
            out["same_bits"] = compare_outputs(
                mine, torch.load(args.compare_outputs))
            print(json.dumps({"card": card_label(),
                              "same_bits": out["same_bits"]}))
        return out
    out["bench"] = bench(device)
    print(json.dumps({"card": card_label(), "bench": {
        f"L={length} B={bsz}": times
        for (length, bsz), times in out["bench"].items()}}))
    return out


if __name__ == "__main__":
    main()
