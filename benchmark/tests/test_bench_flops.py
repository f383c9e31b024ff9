"""The frozen operation and byte counts against hand counts."""
from __future__ import annotations

from benchmark.frozen import flops as F

SPEC = {"d_model": 8, "d_ff": 16, "n_layers": 2, "conv_kernels": [3, 1],
        "conv_reductions": [2, 1], "loss": "combined",
        "backbone_loss": False}


def test_conv_and_matmul_counts():
    b, l = 2, 5
    # conv 3 x (8 -> 4), then 1 x (4 -> 8)
    assert F.conv_forward_flops(SPEC, b, l) == 2 * b * l * (3 * 8 * 4
                                                            + 1 * 4 * 8)
    per_layer = (4 * 2 * b * l * 8 * 8 + 2 * 2 * b * l * l * 8
                 + 2 * 2 * b * l * 8 * 16)
    assert F.matmul_forward_flops(SPEC, b, l) == 2 * per_layer \
        + 2 * b * l * 8 * 24


def test_loss_and_step_counts():
    b, l = 2, 5
    sweep = b * (14 * l) ** 2 * 23 + b * l * 14 * 60
    assert F.loss_forward_flops(SPEC, b, l) == sweep
    bb = dict(SPEC, backbone_loss=True)
    assert F.loss_forward_flops(bb, b, l) == b * (3 * l) ** 2 * 23 \
        + b * l * 14 * 60
    assert F.loss_forward_flops(dict(SPEC, loss="mse"), b, l) == 0.0
    assert F.train_step_flops(SPEC, b, l) == 3 * (
        F.model_forward_flops(SPEC, b, l) + sweep)


def test_real_length_counts():
    assert F.train_flops_real(SPEC, [5, 7]) == (
        F.train_step_flops(SPEC, 1, 5) + F.train_step_flops(SPEC, 1, 7))
    assert F.eval_flops_real(SPEC, [4]) == (
        F.model_forward_flops(SPEC, 1, 4) + F.loss_forward_flops(SPEC, 1, 4))
    # the attention term is quadratic in each protein's own length
    assert F.train_flops_real(SPEC, [10]) > 2 * F.train_flops_real(SPEC, [5])


def test_adam_bytes_and_peaks():
    assert F.adam_bytes(1000) == 28_000
    assert F.peak_bf16("NVIDIA H100 80GB HBM3") == 989.4e12
    assert F.PEAK_FP32 == 67e12 and F.HBM_BYTES_PER_S == 3.35e12
