"""Analytic FLOPs model and MFU accounting for the training step.

The port's copy of the JAX package's ``training/flops.py``, with the same
counts. One optimizer step (forward + backward) at a given (B, L) for any
TrainConfig: conv front-end, attention stack, FFNs, output head, and -- for
dRMSD-family losses -- the NeRF build and the O(M^2) pairwise-distance
sweep. Matmul convention: one (m,n)x(n,k) product is 2*m*n*k FLOPs;
training multiplies the forward count by 3 (the backward computes both
operands' gradients, 2x forward).

MFU is reported against the card's bf16 dense peak whatever the compute
dtype (the PaLM/scaling-book convention): an fp32 run showing low MFU
against it is the signal that the trunk in bf16 has headroom.

Unlike the JAX module, which falls back to a TPU's peak for a device it does
not know, ``peak_flops_per_chip`` raises on a card not in its table.
"""
from __future__ import annotations

from typing import Optional

from protein_transformer_tpu_torch.models.conv_encoder import (
    conv_layer_dims, conv_out_size)

# Dense bf16 peak FLOP/s per card, by a substring of the name
# torch.cuda.get_device_name() gives, most specific first. Source: the
# NVIDIA H100 Tensor Core GPU datasheet (BF16 Tensor Core, without
# sparsity): SXM5 989.4 TFLOP/s at 700 W, PCIe 756, NVL 835.
_PEAK_BF16 = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100 80GB HBM3", 989.4e12),
)


def peak_flops_per_chip(device_name: Optional[str] = None) -> float:
    """Dense bf16 peak FLOP/s of one card, by its name (by default that of
    the current CUDA device); raises ValueError for a card not listed."""
    if device_name is None:
        import torch
        device_name = torch.cuda.get_device_name()
    for sub, peak in _PEAK_BF16:
        if sub in device_name:
            return peak
    raise ValueError(f"no bf16 peak is known for {device_name!r} (known: "
                     f"{', '.join(s for s, _ in _PEAK_BF16)})")


def _encoder_layer_flops(b: int, l: int, d: int, d_ff: int) -> float:
    """Forward FLOPs of one attention encoder/decoder self-attn + FFN block."""
    proj = 4 * 2 * b * l * d * d           # q, k, v, out projections
    attn = 2 * 2 * b * l * l * d           # scores (QK^T) + apply (PV)
    ffn = 2 * 2 * b * l * d * d_ff         # two FFN matmuls
    return proj + attn + ffn


def _cross_attn_flops(b: int, l: int, d: int) -> float:
    return 4 * 2 * b * l * d * d + 2 * 2 * b * l * l * d


def model_forward_flops(cfg, b: int, l: int) -> float:
    """Forward-pass FLOPs of the configured model at batch (b, l)."""
    d, d_ff, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    f = 0.0
    if cfg.model.startswith("conv-enc"):
        kernels = [k for k in (cfg.conv1_size, cfg.conv2_size, cfg.conv3_size)
                   if k]
        reducs = [r for r in (cfg.conv1_reduc, cfg.conv2_reduc,
                              cfg.conv3_reduc) if r]
        for k, din, dout in conv_layer_dims(d, cfg.vocab_size,
                                            cfg.use_embedding, kernels,
                                            reducs, cfg.conv_out_matches_dm):
            f += 2 * b * l * k * din * dout
        d_attn = conv_out_size(d, cfg.vocab_size, cfg.use_embedding,
                               reducs, cfg.conv_out_matches_dm)
    else:
        d_attn = d
    f += nl * _encoder_layer_flops(b, l, d_attn, d_ff)
    if cfg.model == "enc-dec":
        # decoder: self-attn + cross-attn + FFN per layer, same depth
        f += nl * (_encoder_layer_flops(b, l, d_attn, d_ff)
                   + _cross_attn_flops(b, l, d_attn))
    f += 2 * b * l * d_attn * 24            # angle projection head
    return f


def loss_forward_flops(cfg, b: int, l: int) -> float:
    """Forward FLOPs of the loss path: NeRF build + dRMSD pair sweep.

    The pair sweep dominates: M = 3L (backbone_loss without full_metrics)
    or 14L points per protein, ~10 FLOPs per pairwise distance (3 sub,
    3 mul, 2 add, rsqrt~2), computed for BOTH pred and true coordinate
    sets, plus the |D_pred - D_true| reduction (~3/pair).
    """
    if cfg.loss not in ("drmsd", "lndrmsd", "combined"):
        return 0.0
    full = (not cfg.backbone_loss) or cfg.full_metrics
    m = (14 if full else 3) * l
    sweep = b * m * m * (2 * 10 + 3)
    nerf = b * l * 14 * 60                  # per-atom frame compose + place
    return sweep + nerf


def train_step_flops(cfg, b: int, l: int) -> float:
    """Total FLOPs of one training step (forward + backward ~= 3x forward;
    the optimizer update is O(params), negligible)."""
    return 3.0 * (model_forward_flops(cfg, b, l)
                  + loss_forward_flops(cfg, b, l))


def mfu(cfg, b: int, l: int, step_seconds: float,
        n_chips: int = 1, device_name: Optional[str] = None) -> float:
    """Model FLOPs utilization of a measured step time, vs bf16 peak."""
    peak = peak_flops_per_chip(device_name) * n_chips
    return train_step_flops(cfg, b, l) / (step_seconds * peak)
