"""Encoder-only sequence -> angles model (port of models/encoder_only.py).

embed -> PE -> N encoder layers -> Linear(dm -> 24) -> tanh (optional). The
output head starts at the dataset's mean angles: zero weight and
arctanh(angle_means) bias, so the untrained model predicts the mean
structure. The trunk computes in ``dtype`` (models/transformer.py), the head
in float32 whatever that is.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from protein_transformer_tpu_torch.protein.constants import NUM_PREDICTED_ANGLES
from protein_transformer_tpu_torch.models.transformer import Encoder


def angle_mean_bias(angle_means, use_tanh: bool) -> np.ndarray:
    """Output-head bias: arctanh(angle_means) when a tanh follows."""
    am = np.asarray(angle_means, np.float32)
    if use_tanh:
        am = np.arctanh(np.clip(am, -1 + 1e-7, 1 - 1e-7))
    return am.astype(np.float32)


class AngleProjection(nn.Module):
    """Zero-weight output head with the angle-mean bias and optional tanh.
    It computes in its parameters' dtype whatever the trunk's: the angles
    feed the geometric losses, which need full precision."""

    def __init__(self, dim: int, angle_means, use_tanh_out: bool = True):
        super().__init__()
        self.use_tanh_out = use_tanh_out
        self.output_projection = nn.Linear(dim, NUM_PREDICTED_ANGLES * 2)
        with torch.no_grad():
            self.output_projection.weight.zero_()
            self.output_projection.bias.copy_(torch.from_numpy(
                angle_mean_bias(angle_means, use_tanh_out)))

    def forward(self, x):
        out = self.output_projection(
            x.to(self.output_projection.weight.dtype))
        return torch.tanh(out) if self.use_tanh_out else out


def key_padding_mask(ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """(B, 1, 1, L) mask, True at real keys: broadcasts over heads and
    queries."""
    return (ids != pad_id)[:, None, None, :]


class EncoderOnlyTransformer(nn.Module):
    """'enc-only' model family (also 'enc-only-linear-out')."""

    def __init__(self, n_layers: int, n_heads: int, d_model: int, d_ff: int,
                 max_len: int, vocab_size: int, angle_means,
                 use_tanh_out: bool = True, dropout: float = 0.1,
                 pad_id: int = 20, prenorm: bool = True,
                 attn_impl: str = "xla", dtype=None):
        super().__init__()
        self.pad_id = pad_id
        self.encoder = Encoder(vocab_size, d_model, d_ff, n_heads, n_layers,
                               max_len, dropout, prenorm, attn_impl, dtype)
        self.head = AngleProjection(d_model, angle_means, use_tanh_out)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.head(self.encoder(ids, key_padding_mask(ids, self.pad_id)))
