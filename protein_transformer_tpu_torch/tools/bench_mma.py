"""Rate of the tensor-core product that the port's attention kernels and
the dRMSD variants K4b and K4c are built from, on one GPU.

Times ``csrc/mma_probe.cu``: every warp of a grid that fills each SM with
``warps`` warps runs rounds of ``chains`` independent TF32 ``mma.sync``
m16n8k8 products (operands in registers, nothing loaded). With one chain a
warp the time is the product's latency, with many warps and chains the
issue rate of the tensor pipe for this instruction; a split-TF32 product
(``mma_split``) is three of them. Prints, per (warps an SM, chains), the
products an SM completes per microsecond and the TFLOP/s they make (2 x 16
x 8 x 8 operations each), by CUDA events, median of 25, with the card's
name, power limit and SM clock, then the results as one JSON object.

    python -m protein_transformer_tpu_torch.tools.bench_mma

Needs a CUDA device and raises without one.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess

import torch

from protein_transformer_tpu_torch.device import cuda_device
from protein_transformer_tpu_torch.ops import _build
from protein_transformer_tpu_torch.tools.bench_drmsd_kernel import (
    card_label, event_ms)

WARPS_PER_SM = (4, 8, 16, 32)
CHAINS = (1, 8)
ROUNDS = 4096
WARPS_PER_BLOCK = 4
FLOPS_PER_MMA = 2 * 16 * 8 * 8


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mma_probe")
    lib.mma_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.mma_probe.restype = ctypes.c_int
    lib.mma_probe_error_string.argtypes = [ctypes.c_int]
    lib.mma_probe_error_string.restype = ctypes.c_char_p
    return lib


def probe(device, warps: int, chains: int, rounds: int = ROUNDS) -> dict:
    """ms of one probe launch with ``warps`` warps on each SM, each running
    ``rounds`` x ``chains`` products; products per SM a microsecond; TFLOP/s
    of the card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = sms * warps // WARPS_PER_BLOCK
    threads = 32 * WARPS_PER_BLOCK
    out = torch.empty(blocks * threads, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def run():
        err = _lib().mma_probe(chains, blocks, threads, rounds,
                               out.data_ptr(), stream)
        if err:
            raise RuntimeError("mma_probe launch failed: "
                               + _lib().mma_probe_error_string(err).decode())

    ms = event_ms(run)
    products = blocks * WARPS_PER_BLOCK * rounds * chains
    return {"ms": ms, "per_sm_per_us": products / sms / (ms * 1e3),
            "tflops": products * FLOPS_PER_MMA / (ms * 1e-3) / 1e12}


def sm_clock() -> str:
    """The SM clock and its maximum, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    device = cuda_device()
    card = card_label()
    results = {"card": card, "probe": {}}
    for warps in WARPS_PER_SM:
        for chains in CHAINS:
            t = probe(device, warps, chains)
            results["probe"][f"{warps} warps x {chains} chains"] = t
            print(f"mma.sync m16n8k8 TF32, {warps} warps an SM x {chains} "
                  f"independent products: {t['per_sm_per_us']:.1f} products "
                  f"an SM a microsecond, {t['tflops']:.1f} TFLOP/s "
                  f"({t['ms']:.4f} ms; {card})")
    results["sm_clock"] = sm_clock()
    print(f"SM clock after the runs, and its maximum: {results['sm_clock']}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
