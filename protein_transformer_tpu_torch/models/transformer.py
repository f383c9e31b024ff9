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
(``set_dropout_generator``), never from torch's global one.

**Compute dtype.** Every module takes ``dtype``: None computes in the
parameters' own dtype (float32 as built; float64 for a reference run after
``model.double()``), and ``torch.bfloat16`` is the JAX package's
``--compute_dtype bfloat16``. The parameters stay float32 either way, and
each module casts them inside its forward where the flax module does
(explicit ``.to(dtype)``, not ``torch.autocast``, so that the float32
islands are the same), so gradients land in float32 on float32 parameters:

* ``Dense`` / ``Conv`` (flax ``nn.Dense`` / ``nn.Conv(dtype=...)``): input,
  weight and bias in bf16, the product rounded to bf16 and the bias added
  in bf16; ReLU and dropout then run in bf16;
* ``Embeddings``: the table cast to bf16 and gathered, then scaled by
  sqrt(dim) rounded to bf16 (22.625 at dim 512), as flax computes it;
* ``PositionalEncoding``: the table in bf16, the add and dropout in bf16;
* attention: bf16 q, k, v. The materialised branch takes the scores in
  fp32 from the bf16 operands (flax's ``preferred_element_type=float32``: a
  product of two bf16 values is exact in fp32, so the fp32 product of the
  upcast operands is that function), the scale, mask, softmax and dropout
  in fp32, then the probabilities cast to bf16 for P V; the flash branch
  hands bf16 q, k, v to the bf16 kernels and gets bf16 O back;
* ``LayerNorm`` (flax ``nn.LayerNorm(dtype=bf16)``): statistics, scale and
  bias in fp32 on the input promoted to fp32, the result cast to bf16; the
  residual add in bf16.

The output heads (``encoder_only.AngleProjection``, the encoder-decoder's
projection) compute in their parameters' dtype, float32, whatever the
trunk's dtype.

**Tensor parallelism** (``set_model_parallel``; the JAX package's
``parallel/sharding.py`` layout over a 'model' mesh axis): an attention
block computes its rank's share of the heads from the row slices of
wq/wk/wv (and the slices of their replicated biases) and the column slice
of wo; a feed-forward block its slice of the hidden units. Each block takes
its input through ``copy_to_model`` and sums its row-parallel product by
``reduce_from_model`` before adding that layer's bias once. The heads are
split only when the head count and the width divide the axis; otherwise
the block stays replicated. Every branch, flash included, runs on the local
heads.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from protein_transformer_tpu_torch.ops import attention
from protein_transformer_tpu_torch.parallel.sharding import (
    copy_to_model, reduce_from_model)

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


def set_model_parallel(model: nn.Module, axis) -> None:
    """Split every attention and feed-forward block of ``model`` over the
    'model' ``axis`` (``parallel.mesh.AxisGroup``) where its sizes divide
    it; a no-op for an axis of size 1. The parameters the blocks then take
    are the slices of ``parallel.sharding.shard_params``."""
    if axis.size == 1:
        return
    if not getattr(model, "tensor_parallel", True):
        raise ValueError(f"{type(model).__name__} has no tensor-parallel "
                         "layout: run it without a 'model' mesh axis")
    for m in model.modules():
        if isinstance(m, MultiHeadedAttention):
            dim = m.wq.in_features
            if m.n_heads % axis.size == 0 and dim % axis.size == 0:
                m.mp = axis
        elif isinstance(m, PositionwiseFeedForward):
            if m.w_1.out_features % axis.size == 0:
                m.mp = axis


def dense(x: torch.Tensor, weight: torch.Tensor, bias, dtype) -> torch.Tensor:
    """flax's ``nn.Dense(dtype=...)`` on explicit weights: with a dtype the
    product rounded to it, then the bias (None: no bias) added in it;
    without, ``F.linear``."""
    if dtype is None:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


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


def cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in the compute dtype; as it is where that is None."""
    return t if dtype is None else t.to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` as flax's
    ``nn.Dense(dtype=...)``: input, weight and bias cast, the product
    rounded to that dtype and the bias added in it (two roundings, as flax
    takes them). None: the plain ``nn.Linear``. ``bias=False``: no bias."""

    def __init__(self, d_in: int, d_out: int, compute_dtype=None,
                 bias: bool = True):
        super().__init__(d_in, d_out, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


class Conv(nn.Conv1d):
    """Length-preserving ``nn.Conv1d`` on (B, C, L), computing in
    ``compute_dtype`` as flax's ``nn.Conv(dtype=...)``: the convolution
    rounded to that dtype, then the bias added in it."""

    def __init__(self, d_in: int, d_out: int, kernel: int,
                 compute_dtype=None):
        super().__init__(d_in, d_out, kernel, padding=kernel // 2)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return (self._conv_forward(x.to(dt), self.weight.to(dt), None)
                + self.bias.to(dt)[:, None])


class LayerNorm(nn.LayerNorm):
    """Layer norm with flax's eps. With a ``compute_dtype`` (flax's
    ``nn.LayerNorm(dtype=...)``): statistics, scale and bias in fp32 on the
    input promoted to fp32, the result cast to ``compute_dtype``."""

    def __init__(self, dim: int, compute_dtype=None):
        super().__init__(dim, eps=LAYER_NORM_EPS)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class PositionalEncoding(nn.Module):
    """Returns dropout(x + pe), pe in the compute dtype."""

    def __init__(self, dim: int, max_len: int, dropout: float = 0.1,
                 dtype=None):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_positions(max_len, dim)),
            persistent=False)
        self.dropout = Dropout(dropout)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x + cast(self.pe[None, : x.shape[1]],
                                     self.dtype))


class Embeddings(nn.Module):
    """Token embedding scaled by sqrt(dim). With a compute dtype the table
    is cast before the gather and the scale is sqrt(dim) in that dtype, as
    flax computes ``emb * sqrt(asarray(dim, emb.dtype))``."""

    def __init__(self, vocab_size: int, dim: int, dtype=None):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, dim)
        self.dtype = dtype
        self.scale = (math.sqrt(dim) if dtype is None else
                      float(torch.tensor(float(dim), dtype=dtype).sqrt()))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return self.embed(ids) * self.scale
        return F.embedding(ids, self.embed.weight.to(self.dtype)) * self.scale


def materialised_attention(q, k, v, mask, dtype, dropout=None):
    """softmax(q k^T / sqrt(D_qk), masked) v over materialised (B, H, Lq,
    Lk) probabilities. q, k: (B, H, L, D_qk); v: (B, H, Lk, D_v), where D_v
    may differ from D_qk; mask broadcastable to the scores, True where a
    key may be attended to. Masked scores get the smallest fp32 value (not
    -inf). With a ``dtype`` the scores come in fp32 from the upcast
    compute-dtype operands, the scale, mask, softmax and ``dropout`` (a
    module, or None for none) run in fp32, and the probabilities are cast
    to ``dtype`` for P v."""
    if dtype is not None:
        q, k = q.float(), k.float()
    scores = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    if dropout is not None:
        probs = dropout(probs)
    return torch.matmul(cast(probs, dtype), v)


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
    flash path launches its kernels or raises. With a ``dtype`` the
    projections compute in it, and so do the flash kernels; the
    materialised branch takes its scores and softmax in fp32 (module
    docstring)."""

    def __init__(self, dim: int, n_heads: int, dropout: float = 0.1,
                 impl: str = "xla", dtype=None):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"d_model {dim} is not divisible by {n_heads} "
                             "heads")
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention impl {impl!r}; expected one "
                             f"of {ATTENTION_IMPLS}")
        self.impl = impl
        self.n_heads = n_heads
        self.dtype = dtype
        self.wq = Dense(dim, dim, dtype)
        self.wk = Dense(dim, dim, dtype)
        self.wv = Dense(dim, dim, dtype)
        self.wo = Dense(dim, dim, dtype)
        self.dropout = Dropout(dropout)
        # the 'model' axis the heads are split over (set_model_parallel)
        self.mp = None

    def forward(self, q_in, k_in, v_in, mask=None):
        bsz, lq, dim = q_in.shape
        dk = dim // self.n_heads
        self_attention = q_in is k_in
        n_heads, project = self.n_heads, lambda d, x: d(x)
        if self.mp is not None:
            # this rank's heads: the row slices of wq/wk/wv it holds, and
            # the matching slices of their replicated biases
            n_heads //= self.mp.size
            lo = self.mp.rank * n_heads * dk
            q_in, k_in, v_in = self._inputs(q_in, k_in, v_in)

            def project(d, x):
                b = copy_to_model(d.bias, self.mp)[lo:lo + n_heads * dk]
                return dense(x, d.weight, b, self.dtype)

        def split(x):
            return x.reshape(bsz, x.shape[1], n_heads, dk).transpose(1, 2)

        q = split(project(self.wq, q_in))
        k = split(project(self.wk, k_in))
        v = split(project(self.wv, v_in))
        if (self.impl == "flash"
                and (not self.training or self.dropout.p == 0.0)
                and mask is not None and mask.dim() == 4
                and mask.shape[1] == 1 and mask.shape[2] == 1
                and self_attention):
            out = attention.flash_self_attention(
                q, k, v, mask[:, 0, 0, :], sm_scale=1.0 / math.sqrt(dk))
        else:
            out = materialised_attention(q, k, v, mask, self.dtype,
                                         self.dropout)
        out = out.transpose(1, 2).reshape(bsz, lq, n_heads * dk)
        if self.mp is None:
            return self.wo(out)
        # row-parallel wo: the partial products summed, then the bias once
        y = reduce_from_model(dense(out, self.wo.weight, None, self.dtype),
                              self.mp)
        return y + cast(self.wo.bias, self.dtype)

    def _inputs(self, *xs):
        """The block's inputs through ``copy_to_model``, each distinct
        tensor once."""
        seen = {}
        for x in xs:
            if id(x) not in seen:
                seen[id(x)] = copy_to_model(x, self.mp)
        return tuple(seen[id(x)] for x in xs)


class PositionwiseFeedForward(nn.Module):
    """ReLU MLP with dropout on the hidden layer."""

    def __init__(self, dim: int, hidden: int, dropout: float = 0.1,
                 dtype=None):
        super().__init__()
        self.w_1 = Dense(dim, hidden, dtype)
        self.w_2 = Dense(hidden, dim, dtype)
        self.dropout = Dropout(dropout)
        # the 'model' axis the hidden units are split over
        # (set_model_parallel)
        self.mp = None

    def forward(self, x):
        if self.mp is None:
            return self.w_2(self.dropout(torch.relu(self.w_1(x))))
        h = self.dropout(torch.relu(self.w_1(copy_to_model(x, self.mp))))
        # row-parallel w_2: the partial products summed, then the bias once
        y = reduce_from_model(
            dense(h, self.w_2.weight, None, self.w_2.compute_dtype), self.mp)
        return y + cast(self.w_2.bias, self.w_2.compute_dtype)


class SublayerConnection(nn.Module):
    """prenorm: x + dropout(f(norm(x))); postnorm: norm(x + dropout(f(x)))."""

    def __init__(self, dim: int, dropout: float = 0.1, prenorm: bool = True,
                 dtype=None):
        super().__init__()
        self.norm = LayerNorm(dim, dtype)
        self.dropout = Dropout(dropout)
        self.prenorm = prenorm

    def forward(self, x, sublayer):
        if self.prenorm:
            return x + self.dropout(sublayer(self.norm(x)))
        return self.norm(x + self.dropout(sublayer(x)))


class EncoderLayer(nn.Module):
    """Self-attention + feed-forward encoder layer."""

    def __init__(self, dim: int, dff: int, n_heads: int, dropout: float = 0.1,
                 prenorm: bool = True, attn_impl: str = "xla", dtype=None):
        super().__init__()
        self.attn = MultiHeadedAttention(dim, n_heads, dropout, attn_impl,
                                         dtype)
        self.ff = PositionwiseFeedForward(dim, dff, dropout, dtype)
        self.sublayer = nn.ModuleList(
            [SublayerConnection(dim, dropout, prenorm, dtype)
             for _ in range(2)])

    def forward(self, x, mask):
        x = self.sublayer[0](x, lambda y: self.attn(y, y, y, mask))
        return self.sublayer[1](x, self.ff)


class Encoder(nn.Module):
    """Embedding + positional encoding + N encoder layers."""

    def __init__(self, vocab_size: int, dim: int, dff: int, n_heads: int,
                 n_layers: int, max_len: int, dropout: float = 0.1,
                 prenorm: bool = True, attn_impl: str = "xla", dtype=None):
        super().__init__()
        self.embeddings = Embeddings(vocab_size, dim, dtype)
        self.pe = PositionalEncoding(dim, max_len, dropout, dtype)
        self.dropout = Dropout(dropout)
        self.layers = nn.ModuleList(
            [EncoderLayer(dim, dff, n_heads, dropout, prenorm, attn_impl,
                          dtype)
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
                 prenorm: bool = True, dtype=None):
        super().__init__()
        self.attn = MultiHeadedAttention(dim, n_heads, dropout, dtype=dtype)
        self.cross_attn = MultiHeadedAttention(dim, n_heads, dropout,
                                               dtype=dtype)
        self.ff = PositionwiseFeedForward(dim, dff, dropout, dtype)
        self.sublayer = nn.ModuleList(
            [SublayerConnection(dim, dropout, prenorm, dtype)
             for _ in range(3)])

    def forward(self, x, enc_out, tgt_mask, src_mask):
        x = self.sublayer[0](x, lambda y: self.attn(y, y, y, tgt_mask))
        x = self.sublayer[1](
            x, lambda y: self.cross_attn(y, enc_out, enc_out, src_mask))
        return self.sublayer[2](x, self.ff)


class Decoder(nn.Module):
    """Linear input embedding + positional encoding + N decoder layers."""

    def __init__(self, d_out: int, dim: int, dff: int, n_heads: int,
                 n_layers: int, max_len: int, dropout: float = 0.1,
                 prenorm: bool = True, dtype=None):
        super().__init__()
        self.embed = Dense(d_out, dim, dtype)
        self.pe = PositionalEncoding(dim, max_len, dropout, dtype)
        self.dropout = Dropout(dropout)
        self.layers = nn.ModuleList(
            [DecoderLayer(dim, dff, n_heads, dropout, prenorm, dtype)
             for _ in range(n_layers)])

    def forward(self, tgt, enc_out, tgt_mask, src_mask):
        x = self.embed(tgt)
        # the encoder's quirk: x + PE(x), where PE(x) already adds x
        x = self.dropout(x + self.pe(x))
        for layer in self.layers:
            x = layer(x, enc_out, tgt_mask, src_mask)
        return x
