"""Transformer encoder and decoder building blocks as torch ``nn.Module``s.

Port of protein_transformer_tpu/models/transformer.py:

* scaled embeddings (x sqrt(dm)) and sinusoidal positional encoding, with
  the reference's quirk kept: ``PositionalEncoding`` returns x + pe and the
  encoder adds x once more, so the embedding enters twice;
* pre-LN (or post-LN) residual sublayers, no final layer norm;
* multi-head attention over a key-padding mask: masked scores get the
  smallest fp32 value (not -inf), the softmax runs in fp32, and padded
  queries still attend to the real keys. With ``impl="flash"`` the
  self-attention of every call without dropout on the probabilities goes
  through ``ops/attention.py`` (the flash kernels on a CUDA device), which
  computes the same function without materialising the probabilities;
* the decoder: a linear embedding of the 24 target sin/cos values, the same
  x + PE(x) quirk, then layers of causal self-attention, cross-attention on
  the encoder output under its key-padding mask, and the feed-forward.
  Neither attention of a decoder layer is key-padding-masked
  self-attention, so both always materialise their probabilities.

Layer norms use eps 1e-6, flax's default (torch's is 1e-5). Dropout sits
where the JAX modules have it, is inactive in ``eval()`` mode, and draws its
masks from an explicit ``torch.Generator`` that the trainer owns and seeds
(``set_dropout_generator``), never from torch's global one. The port
computes in fp32 throughout (the JAX package's bf16 option is not ported).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from protein_transformer_tpu_torch.ops import attention

LAYER_NORM_EPS = 1e-6
ATTENTION_IMPLS = ("xla", "flash")


class Dropout(nn.Module):
    """Inverted dropout whose keep-mask is drawn from ``self.generator``, a
    ``torch.Generator`` on the input's device. Identity in eval mode and at
    p == 0; in train mode with p > 0 and no generator set it raises."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator: "
                               "call set_dropout_generator(model, g)")
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                              generator=self.generator)
        return x * keep / (1.0 - self.p)


def set_dropout_generator(model: nn.Module,
                          generator: torch.Generator) -> None:
    """Point every ``Dropout`` of ``model`` at ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    """Sinusoidal positional encodings (max_len, dim), float32."""
    pe = np.zeros((max_len, dim), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * -(np.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div[: pe[:, 1::2].shape[1]])
    return pe


class PositionalEncoding(nn.Module):
    """Returns dropout(x + pe)."""

    def __init__(self, dim: int, max_len: int, dropout: float = 0.1):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positions(max_len, dim)),
            persistent=False)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x + self.pe[None, : x.shape[1]])


class Embeddings(nn.Module):
    """Token embedding scaled by sqrt(dim)."""

    def __init__(self, vocab_size: int, dim: int):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, dim)
        self.scale = math.sqrt(dim)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embed(ids) * self.scale


class MultiHeadedAttention(nn.Module):
    """Multi-head attention; mask broadcastable to (B, 1, Lq, Lk), True where
    a key may be attended to.

    impl: 'xla' (the JAX package's name for it) materialises the
    (B, H, Lq, Lk) probabilities, which dropout on them needs. 'flash' sends
    key-padding-masked self-attention without dropout on the probabilities
    (eval mode, or dropout == 0) through ``ops.attention
    .flash_self_attention``, and takes the materialised branch anywhere
    else, so one setting serves a whole model. That is the meaning of the
    setting, as in the JAX package, not a fallback: on a CUDA tensor the
    flash path launches its kernels or raises."""

    def __init__(self, dim: int, n_heads: int, dropout: float = 0.1,
                 impl: str = "xla"):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"d_model {dim} is not divisible by {n_heads} "
                             "heads")
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention impl {impl!r}; expected one "
                             f"of {ATTENTION_IMPLS}")
        self.impl = impl
        self.n_heads = n_heads
        self.wq = nn.Linear(dim, dim)
        self.wk = nn.Linear(dim, dim)
        self.wv = nn.Linear(dim, dim)
        self.wo = nn.Linear(dim, dim)
        self.dropout = Dropout(dropout)

    def forward(self, q_in, k_in, v_in, mask=None):
        bsz, lq, dim = q_in.shape
        dk = dim // self.n_heads

        def split(x):
            return x.reshape(bsz, x.shape[1], self.n_heads, dk).transpose(1, 2)

        q, k, v = split(self.wq(q_in)), split(self.wk(k_in)), split(self.wv(v_in))
        if (self.impl == "flash"
                and (not self.training or self.dropout.p == 0.0)
                and mask is not None and mask.dim() == 4
                and mask.shape[1] == 1 and mask.shape[2] == 1
                and q_in is k_in):
            out = attention.flash_self_attention(
                q, k, v, mask[:, 0, 0, :], sm_scale=1.0 / math.sqrt(dk))
            return self.wo(out.transpose(1, 2).reshape(bsz, lq, dim))
        scores = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(dk)
        if mask is not None:
            scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
        probs = self.dropout(torch.softmax(scores, dim=-1))
        out = torch.matmul(probs, v)
        return self.wo(out.transpose(1, 2).reshape(bsz, lq, dim))


class PositionwiseFeedForward(nn.Module):
    """ReLU MLP with dropout on the hidden layer."""

    def __init__(self, dim: int, hidden: int, dropout: float = 0.1):
        super().__init__()
        self.w_1 = nn.Linear(dim, hidden)
        self.w_2 = nn.Linear(hidden, dim)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        return self.w_2(self.dropout(torch.relu(self.w_1(x))))


class SublayerConnection(nn.Module):
    """prenorm: x + dropout(f(norm(x))); postnorm: norm(x + dropout(f(x)))."""

    def __init__(self, dim: int, dropout: float = 0.1, prenorm: bool = True):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.dropout = Dropout(dropout)
        self.prenorm = prenorm

    def forward(self, x, sublayer):
        if self.prenorm:
            return x + self.dropout(sublayer(self.norm(x)))
        return self.norm(x + self.dropout(sublayer(x)))


class EncoderLayer(nn.Module):
    """Self-attention + feed-forward encoder layer."""

    def __init__(self, dim: int, dff: int, n_heads: int, dropout: float = 0.1,
                 prenorm: bool = True, attn_impl: str = "xla"):
        super().__init__()
        self.attn = MultiHeadedAttention(dim, n_heads, dropout, attn_impl)
        self.ff = PositionwiseFeedForward(dim, dff, dropout)
        self.sublayer = nn.ModuleList(
            [SublayerConnection(dim, dropout, prenorm) for _ in range(2)])

    def forward(self, x, mask):
        x = self.sublayer[0](x, lambda y: self.attn(y, y, y, mask))
        return self.sublayer[1](x, self.ff)


class Encoder(nn.Module):
    """Embedding + positional encoding + N encoder layers."""

    def __init__(self, vocab_size: int, dim: int, dff: int, n_heads: int,
                 n_layers: int, max_len: int, dropout: float = 0.1,
                 prenorm: bool = True, attn_impl: str = "xla"):
        super().__init__()
        self.embeddings = Embeddings(vocab_size, dim)
        self.pe = PositionalEncoding(dim, max_len, dropout)
        self.dropout = Dropout(dropout)
        self.layers = nn.ModuleList(
            [EncoderLayer(dim, dff, n_heads, dropout, prenorm, attn_impl)
             for _ in range(n_layers)])

    def forward(self, ids, mask):
        x = self.embeddings(ids)
        # Reference quirk: x + PE(x), where PE(x) already adds x.
        x = self.dropout(x + self.pe(x))
        for layer in self.layers:
            x = layer(x, mask)
        return x


class DecoderLayer(nn.Module):
    """Masked self-attention + cross-attention on the encoder output +
    feed-forward."""

    def __init__(self, dim: int, dff: int, n_heads: int, dropout: float = 0.1,
                 prenorm: bool = True):
        super().__init__()
        self.attn = MultiHeadedAttention(dim, n_heads, dropout)
        self.cross_attn = MultiHeadedAttention(dim, n_heads, dropout)
        self.ff = PositionwiseFeedForward(dim, dff, dropout)
        self.sublayer = nn.ModuleList(
            [SublayerConnection(dim, dropout, prenorm) for _ in range(3)])

    def forward(self, x, enc_out, tgt_mask, src_mask):
        x = self.sublayer[0](x, lambda y: self.attn(y, y, y, tgt_mask))
        x = self.sublayer[1](
            x, lambda y: self.cross_attn(y, enc_out, enc_out, src_mask))
        return self.sublayer[2](x, self.ff)


class Decoder(nn.Module):
    """Linear input embedding + positional encoding + N decoder layers."""

    def __init__(self, d_out: int, dim: int, dff: int, n_heads: int,
                 n_layers: int, max_len: int, dropout: float = 0.1,
                 prenorm: bool = True):
        super().__init__()
        self.embed = nn.Linear(d_out, dim)
        self.pe = PositionalEncoding(dim, max_len, dropout)
        self.dropout = Dropout(dropout)
        self.layers = nn.ModuleList(
            [DecoderLayer(dim, dff, n_heads, dropout, prenorm)
             for _ in range(n_layers)])

    def forward(self, tgt, enc_out, tgt_mask, src_mask):
        x = self.embed(tgt)
        # the encoder's quirk: x + PE(x), where PE(x) already adds x
        x = self.dropout(x + self.pe(x))
        for layer in self.layers:
            x = layer(x, enc_out, tgt_mask, src_mask)
        return x
