"""Convolutional encoder model (port of models/conv_encoder.py).

'conv-enc' family: up to 3 length-preserving odd-kernel 1-D convolutions
between the (optional) embedding and the attention stack, with per-layer
channel reductions. Without an embedding the input is one-hot and the
positional encoding comes after the convolutions. torch's Conv1d works on
(B, C, L), so the stack is transposed in and out of the JAX package's
(B, L, C) layout. With a compute ``dtype`` the one-hot input and the
convolutions are in it too, as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from protein_transformer_tpu_torch.models.encoder_only import (
    AngleProjection, key_padding_mask)
from protein_transformer_tpu_torch.models.transformer import (
    Conv, Dropout, Embeddings, EncoderLayer, PositionalEncoding)


def conv_out_size(d_model: int, d_in: int, use_embedding: bool,
                  conv_dim_reductions: Sequence[float],
                  conv_out_matches_dm: bool) -> int:
    """Channel count entering the attention stack."""
    if conv_out_matches_dm:
        return d_model
    d = float(d_model if use_embedding else d_in)
    for dr in conv_dim_reductions:
        d /= dr
    return int(d)


def conv_layer_dims(d_model: int, d_in: int, use_embedding: bool,
                    conv_kernel_sizes: Sequence[int],
                    conv_dim_reductions: Sequence[float],
                    conv_out_matches_dm: bool) -> list[tuple[int, int, int]]:
    """(kernel, din, dout) per conv layer."""
    dims = []
    din = d_model if use_embedding else d_in
    n = len(conv_kernel_sizes)
    for i, (k, dr) in enumerate(zip(conv_kernel_sizes, conv_dim_reductions)):
        dout = d_model if (i == n - 1 and conv_out_matches_dm) else int(din // dr)
        dims.append((k, din, dout))
        din = dout
    return dims


class ConvEncoderOnlyTransformer(nn.Module):
    """'conv-enc' model family (conv-enc|k1,k2,k3|r1,r2,r3 names)."""

    def __init__(self, n_layers: int, n_heads: int, d_model: int, d_ff: int,
                 max_len: int, vocab_size: int, angle_means,
                 conv_kernel_sizes: Sequence[int],
                 conv_dim_reductions: Sequence[float],
                 use_tanh_out: bool = True, use_embedding: bool = True,
                 conv_out_matches_dm: bool = True, dropout: float = 0.1,
                 pad_id: int = 20, prenorm: bool = True,
                 attn_impl: str = "xla", dtype=None):
        super().__init__()
        self.pad_id = pad_id
        self.vocab_size = vocab_size
        self.use_embedding = use_embedding
        self.dtype = dtype
        d_attn = conv_out_size(d_model, vocab_size, use_embedding,
                               conv_dim_reductions, conv_out_matches_dm)
        if use_embedding:
            self.embeddings = Embeddings(vocab_size, d_model, dtype)
            self.pe = PositionalEncoding(d_model, max_len, dropout, dtype)
            self.dropout = Dropout(dropout)
        else:
            self.pe = PositionalEncoding(d_attn, max_len, dropout, dtype)
        convs = []
        for k, din, dout in conv_layer_dims(
                d_model, vocab_size, use_embedding, conv_kernel_sizes,
                conv_dim_reductions, conv_out_matches_dm):
            if k % 2 != 1:
                raise ValueError(f"conv kernel size {k} must be odd to "
                                 "preserve length")
            convs.append(Conv(din, dout, k, dtype))
        self.convs = nn.ModuleList(convs)
        self.layers = nn.ModuleList(
            [EncoderLayer(d_attn, d_ff, n_heads, dropout, prenorm, attn_impl,
                          dtype)
             for _ in range(n_layers)])
        self.head = AngleProjection(d_attn, angle_means, use_tanh_out)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        mask = key_padding_mask(ids, self.pad_id)
        if self.use_embedding:
            x = self.embeddings(ids)
            # Reference quirk: x + PE(x), where PE(x) already adds x.
            x = self.dropout(x + self.pe(x))
        else:
            x = nn.functional.one_hot(ids.long(), self.vocab_size).to(
                self.dtype or torch.float32)
        x = x.transpose(1, 2)
        for conv in self.convs:
            x = conv(x)
        x = x.transpose(1, 2)
        if not self.use_embedding:
            x = x + self.pe(x)
        for layer in self.layers:
            x = layer(x, mask)
        return self.head(x)
