"""The conv-enc model in plain PyTorch, float32: the reference forward pass.

It follows the original protein-transformer's conv-enc family
(github.com/jonathanking/protein-transformer): an embedding scaled by
sqrt(d_model), the sinusoidal positional encoding added as x + PE(x) where
PE(x) = dropout(x + pe) already holds x (the original's quirk, so the
embedding enters twice), dropout, up to three length-preserving 1-D
convolutions with no activation between them, then pre-LN encoder layers
(multi-head self-attention under the key-padding mask, a ReLU feed-forward,
each sublayer x + dropout(f(norm(x))), layer norms with eps 1e-6), and a
Linear(d_model -> 24) head under tanh.

Parameter names are those of the port's modules, so one dict of weights
serves both. Dropout draws its keep-masks with
``torch.empty_like(x).bernoulli_(1 - p, generator=g)`` in module order: at
each call the positional encoding's dropout, the outer dropout, then per
layer the attention probabilities, the first sublayer, the feed-forward's
hidden layer and the second sublayer. That is the order and the draw of
the program's ``Dropout`` modules, so a generator seeded alike gives both
sides the same masks.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

LN_EPS = 1e-6


def sinusoid_table(max_len: int, dim: int) -> torch.Tensor:
    pe = np.zeros((max_len, dim), np.float32)
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * -(np.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: pe[:, 1::2].shape[1]])
    return torch.from_numpy(pe)


def conv_dims(d_model: int, kernels, reductions) -> list:
    """(kernel, din, dout) of each convolution; the last one returns to
    d_model (the original's conv_out_matches_dm)."""
    dims, din = [], d_model
    for i, (k, r) in enumerate(zip(kernels, reductions)):
        dout = d_model if i == len(kernels) - 1 else int(din // r)
        dims.append((k, din, dout))
        din = dout
    return dims


class _Named(nn.Module):
    """A container that only gives its children their parameter names."""


class ConvEncoder(nn.Module):
    def __init__(self, spec: dict):
        super().__init__()
        d, dff, vocab = spec["d_model"], spec["d_ff"], spec["vocab_size"]
        self.spec = spec
        self.n_heads = spec["n_heads"]
        self.pad_id = spec["pad_id"]
        self.p = spec["dropout"]
        self.embeddings = _Named()
        self.embeddings.embed = nn.Embedding(vocab, d)
        self.convs = nn.ModuleList(
            nn.Conv1d(din, dout, k, padding=k // 2)
            for k, din, dout in conv_dims(d, spec["conv_kernels"],
                                          spec["conv_reductions"]))
        self.layers = nn.ModuleList()
        for _ in range(spec["n_layers"]):
            layer = _Named()
            layer.attn = _Named()
            for w in ("wq", "wk", "wv", "wo"):
                setattr(layer.attn, w, nn.Linear(d, d))
            layer.ff = _Named()
            layer.ff.w_1 = nn.Linear(d, dff)
            layer.ff.w_2 = nn.Linear(dff, d)
            layer.sublayer = nn.ModuleList()
            for _ in range(2):
                sub = _Named()
                sub.norm = nn.LayerNorm(d, eps=LN_EPS)
                layer.sublayer.append(sub)
            self.layers.append(layer)
        self.head = _Named()
        self.head.output_projection = nn.Linear(d, 24)
        self.register_buffer("pe", sinusoid_table(spec["max_seq_len"], d),
                             persistent=False)
        self.generator: torch.Generator | None = None

    def drop(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                              generator=self.generator)
        return x * keep / (1.0 - self.p)

    def attention(self, a, x, mask):
        bsz, length, d = x.shape
        h = self.n_heads
        dk = d // h

        def split(t):
            return t.reshape(bsz, length, h, dk).transpose(1, 2)

        q, k, v = split(a.wq(x)), split(a.wk(x)), split(a.wv(x))
        s = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(dk)
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
        o = torch.matmul(self.drop(torch.softmax(s, dim=-1)), v)
        return a.wo(o.transpose(1, 2).reshape(bsz, length, d))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        mask = (ids != self.pad_id)[:, None, None, :]
        d = self.spec["d_model"]
        x = self.embeddings.embed(ids) * math.sqrt(d)
        x = self.drop(x + self.drop(x + self.pe[None, : ids.shape[1]]))
        x = x.transpose(1, 2)
        for conv in self.convs:
            x = conv(x)
        x = x.transpose(1, 2)
        for layer in self.layers:
            s0, s1 = layer.sublayer
            x = x + self.drop(self.attention(layer.attn, s0.norm(x), mask))
            h = self.drop(torch.relu(layer.ff.w_1(s1.norm(x))))
            x = x + self.drop(layer.ff.w_2(h))
        return torch.tanh(self.head.output_projection(x))
