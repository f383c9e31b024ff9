"""The traced epoch's matrix products of an 'mla-moe' cell at the padded
shapes run (``moonlight_flops``, three times the forward's) at the bf16
dense peak, over the device seconds of the GEMM and "other" categories,
in %. cuBLAS's bf16 products on the H100 run as ``nvjet_*`` kernels, whose
names the frozen categoriser leaves in "other" (the grouped CUTLASS and
the fp32 products land in GEMM); "other" also holds the dispatch's sort
and index kernels, so the share reads low by their few ms a step."""
from benchmark import moonlight_flops as MF
from benchmark import readers
from benchmark.frozen import flops as F


def read(run):
    sec = [readers.category_seconds(run, c) for c in ("GEMM", "other")]
    if run.kind != "train" or not any(sec) or "mla_moe" not in run.config:
        return None
    ops = sum(3.0 * MF.forward_flops(run.config, r, n)
              for r, n in run.traced["rec"].shapes)
    return 100.0 * ops / F.peak_bf16(run.device_name) / sum(
        s or 0.0 for s in sec)
