"""Analytic operation and byte counts of the model step: the yardstick's.

A frozen copy of ``protein_transformer_tpu_torch/training/flops.py`` at
commit 026902350ad78ec8349700d5f0a9d57ffc236aec, reading the benchmark's
configuration dict instead of a TrainConfig, with what the benchmark adds:
the counts at each protein's real length (``*_real``), the matrix-product
and convolution shares of the forward count at a padded shape, and Adam's
least bytes. Matmul convention: one (m, n) x (n, k) product is 2 m n k
operations; a training step is three times its forward (the backward
computes the gradients of both operands).

Peaks (NVIDIA H100 SXM5 datasheet, dense): bf16 989.4 TFLOP/s, the MFU
convention of the port; float32 outside the tensor cores 67 TFLOP/s, the
rate of every fp32 product with TF32 off; HBM3 3.35 TB/s.
"""
from __future__ import annotations

PEAK_BF16 = (("H100 PCIe", 756e12), ("H100 NVL", 835e12),
             ("H100 80GB HBM3", 989.4e12))
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12
# Adam's least traffic a parameter: parameter, gradient and both moments
# read, parameter and both moments written, float32 each
ADAM_BYTES_PER_PARAM = 28


def peak_bf16(device_name: str) -> float:
    for sub, peak in PEAK_BF16:
        if sub in device_name:
            return peak
    raise ValueError(f"no bf16 peak is known for {device_name!r}")


def conv_dims(spec: dict) -> list:
    """(kernel, din, dout) of each convolution (conv_out_matches_dm)."""
    dims, din = [], spec["d_model"]
    kernels, reds = spec["conv_kernels"], spec["conv_reductions"]
    for i, (k, r) in enumerate(zip(kernels, reds)):
        dout = spec["d_model"] if i == len(kernels) - 1 else int(din // r)
        dims.append((k, din, dout))
        din = dout
    return dims


def _encoder_layer_flops(b, l, d, d_ff) -> float:
    proj = 4 * 2 * b * l * d * d
    attn = 2 * 2 * b * l * l * d
    ffn = 2 * 2 * b * l * d * d_ff
    return proj + attn + ffn


def conv_forward_flops(spec: dict, b: int, l: int) -> float:
    return float(sum(2 * b * l * k * din * dout
                     for k, din, dout in conv_dims(spec)))


def matmul_forward_flops(spec: dict, b: int, l: int) -> float:
    """Matrix products of the forward pass: the attention stack and the
    output head."""
    d = spec["d_model"]
    return (spec["n_layers"] * _encoder_layer_flops(b, l, d, spec["d_ff"])
            + 2 * b * l * d * 24)


def model_forward_flops(spec: dict, b: int, l: int) -> float:
    return conv_forward_flops(spec, b, l) + matmul_forward_flops(spec, b, l)


def loss_forward_flops(spec: dict, b: int, l: int) -> float:
    """The NeRF build and the dRMSD pair sweep of the loss (3 L atoms with
    ``backbone_loss``, else 14 L), ~23 operations a pair."""
    if spec["loss"] not in ("drmsd", "lndrmsd", "combined"):
        return 0.0
    m = (3 if spec["backbone_loss"] else 14) * l
    return b * m * m * (2 * 10 + 3) + b * l * 14 * 60


def train_step_flops(spec: dict, b: int, l: int) -> float:
    return 3.0 * (model_forward_flops(spec, b, l)
                  + loss_forward_flops(spec, b, l))


def train_flops_real(spec: dict, lens) -> float:
    """A training step's operations at each real protein's own length."""
    return sum(train_step_flops(spec, 1, int(n)) for n in lens)


def eval_flops_real(spec: dict, lens) -> float:
    """A scoring step's forward operations at the real lengths."""
    return sum(model_forward_flops(spec, 1, int(n))
               + loss_forward_flops(spec, 1, int(n)) for n in lens)


def adam_bytes(n_params: int) -> int:
    return ADAM_BYTES_PER_PARAM * n_params
