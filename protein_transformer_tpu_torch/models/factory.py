"""Model construction from a training config.

Supports the reference's model-name sugar: 'conv-enc|k1,k2,k3|r1,r2,r3'
encodes the convolution topology, and a 'linear-out' substring drops the
output tanh. 'mla-moe' is the latent-attention, sparse-expert trunk of
``models/mla_moe.py``, its architecture in ``cfg.mla_moe``.
"""
from __future__ import annotations

import torch
from torch import nn

from protein_transformer_tpu_torch.models.conv_encoder import (
    ConvEncoderOnlyTransformer)
from protein_transformer_tpu_torch.models.enc_dec import Transformer
from protein_transformer_tpu_torch.models.encoder_only import (
    EncoderOnlyTransformer)
from protein_transformer_tpu_torch.models.mla_moe import MLAMoETransformer


def parse_conv_kernel_info_from_model_name(mname: str):
    """'conv-enc|3,7,11|2,2,2' -> ([3, 7, 11], [2.0, 2.0, 2.0])."""
    try:
        _, kernel_sizes, dim_reducs = mname.split("|")
    except ValueError:
        return [], []
    return ([int(k) for k in kernel_sizes.split(",")],
            [float(r) for r in dim_reducs.split(",")])


def resolve_attention_impl(impl: str) -> str:
    """'auto' -> 'xla', the materialised branch, as in the JAX package;
    'flash' is asked for by name. The times of both branches on the H100
    are in PERF.md."""
    if impl == "auto":
        return "xla"
    return impl


# cfg.compute_dtype -> the modules' ``dtype``: None computes in the
# parameters' dtype (float32), bfloat16 casts as the flax modules do
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def make_model(cfg, angle_means) -> nn.Module:
    """Build the model cfg names (on the CPU; the caller moves it). The
    parameters are float32 whatever ``cfg.compute_dtype``."""
    name = cfg.model
    common = dict(
        n_layers=cfg.n_layers, n_heads=cfg.n_heads, d_model=cfg.d_model,
        d_ff=cfg.d_ff, max_len=cfg.max_seq_len, vocab_size=cfg.vocab_size,
        angle_means=[float(a) for a in angle_means],
        use_tanh_out="linear-out" not in name, dropout=cfg.dropout,
        pad_id=cfg.pad_id, prenorm=not cfg.postnorm,
        attn_impl=resolve_attention_impl(cfg.attention_impl),
        dtype=COMPUTE_DTYPES[cfg.compute_dtype])
    if name.startswith("enc-only"):
        return EncoderOnlyTransformer(**common)
    if "conv-enc" in name:
        kernels, reducs = parse_conv_kernel_info_from_model_name(name)
        if not kernels:
            kernels = [k for k in (cfg.conv1_size, cfg.conv2_size,
                                   cfg.conv3_size) if k]
            reducs = [r for r in (cfg.conv1_reduc, cfg.conv2_reduc,
                                  cfg.conv3_reduc) if r]
        if len(kernels) > 3:
            raise ValueError("at most 3 convolution layers supported")
        return ConvEncoderOnlyTransformer(
            conv_kernel_sizes=kernels, conv_dim_reductions=reducs,
            use_embedding=cfg.use_embedding,
            conv_out_matches_dm=cfg.conv_out_matches_dm, **common)
    if name == "mla-moe":
        return MLAMoETransformer(
            n_layers=cfg.n_layers, n_heads=cfg.n_heads, d_model=cfg.d_model,
            d_ff=cfg.d_ff, max_len=cfg.max_seq_len,
            vocab_size=cfg.vocab_size, angle_means=common["angle_means"],
            arch=cfg.mla_moe, pad_id=cfg.pad_id, dtype=common["dtype"])
    if name == "enc-dec":
        common.pop("n_layers")
        common.pop("use_tanh_out")
        return Transformer(
            n_enc_layers=cfg.n_layers, n_dec_layers=cfg.n_layers,
            fraction_complete_tf=cfg.fraction_complete_tf,
            fraction_subseq_tf=cfg.fraction_subseq_tf, **common)
    raise ValueError(f"Unknown model architecture: {name}")


def model_args(model: nn.Module, seq, ang) -> tuple:
    """The positional arguments of ``model``'s forward for a batch's ids and
    target angles: the encoder models read the ids alone, the encoder-decoder
    also the targets it is teacher-forced on."""
    return (seq, ang) if isinstance(model, Transformer) else (seq,)
