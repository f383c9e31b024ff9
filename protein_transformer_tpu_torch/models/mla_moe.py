"""Latent-attention, sparse-expert trunk: the 'mla-moe' model family.

The layers of DeepSeek-V3 (arXiv:2412.19437, section 2.1) as published for
Moonlight-16B-A3B, as the trunk of the sequence -> angles model: an
embedding of the amino-acid ids (a plain lookup: no sqrt(d) scale, no
absolute positions), the layers, a final RMSNorm, then the angle head of
``encoder_only.AngleProjection``. ``cfg.mla_moe`` holds the published
config.json keys the family reads (``config.MLA_MOE_KEYS``); d_model,
n_layers, n_heads and d_ff are hidden_size, num_hidden_layers,
num_attention_heads and intermediate_size.

* **Layer**: h = x + MLA(RMSNorm(x)), then y = h + FFN(RMSNorm(h)); the
  FFN of the first ``first_k_dense_replace`` layers is a SwiGLU of d_ff,
  the others are MoE.
* **MLA**: q = W_q x splits per head into q_nope (qk_nope_head_dim) and
  q_pe (qk_rope_head_dim); [c_kv, k_pe] = W_kva x (kv_lora_rank +
  qk_rope_head_dim); [k_nope, v] = W_kvb RMSNorm(c_kv) per head. RoPE
  rotates adjacent pairs (the reference code's complex-pair form, theta
  ``rope_theta``, positions 0..L-1 of each protein) of q_pe and of the one
  k_pe, which every head shares. Q K^T at D_qk = nope + rope, P V at D_v,
  scale 1/sqrt(D_qk), through ``transformer.materialised_attention``.
* **MoE**: scores s = sigmoid(W_g u); the experts of a token are the top
  ``num_experts_per_tok`` of s + b, b the correction bias (a buffer that no
  gradient trains); the weights g = s_sel / sum(s_sel) (the published
  ``norm_topk_prob``) times ``routed_scaling_factor``; out =
  SwiGLU_shared(u) (width n_shared_experts x moe_intermediate_size) +
  sum_k g_k SwiGLU_{e_k}(u).
  Every assignment is computed: no capacity, no dropped token.
* **Dispatch without a host synchronisation**: the T k assignments are
  sorted by expert (a buffer whose size the batch's shape fixes), the
  products grouped over the experts by ``torch._grouped_mm`` with the
  groups' end offsets left on the device, and the outputs brought back to
  token order by a gather and summed over each token's k slots with their
  weights: the weighted combine, deterministic where a scatter-add would
  race.
* **Balancing** (counts and probabilities over real residues only): each
  forward leaves ``balance``: the objective's term alpha sum_i f_i P_i per
  protein (V3 eqs. 17-20: f_i = E / (k T) x the protein's residues routed
  to i, P_i the mean over its residues of s_i / sum_j s_j), summed over
  the expert layers and averaged over the real proteins, which
  ``trainer.compute_losses`` adds in train mode, and each layer's loads.
  After each optimizer step the trainer's ``update_buffers`` moves each
  layer's b, a buffer of the training state (and of its checkpoints), by
  gamma sign(mean load - load_i) (aux-loss-free balancing), from the loads
  of that step's forward. alpha (``seq_aux_alpha``) and gamma
  (``bias_update_speed``) are V3's pre-training values, which the
  published config does not give.

**Departures from the causal LM** (stated, not guessed): attention is
bidirectional under the key-padding mask, as a structure model reads whole
proteins; the vocabulary is the 22 amino-acid ids and the LM head is the
angle head; no dropout (the published config has none). f counts the
experts a token is routed to (by s + b).

**Precision** (``dtype`` bfloat16, the published one, on the conventions of
``models/transformer.py``): parameters, gradients and Adam in fp32, every
product in bf16 (weights cast inside the forward), the residual stream in
bf16. fp32 islands: the RMSNorm statistics and scale (on the input
promoted to fp32, the result cast to bf16); RoPE (on q_pe and k_pe
promoted, as the reference code rotates them); the attention scores,
mask and softmax; the router (W_g u on the upcast input, the sigmoid, the
selection and the weights); the weighted combine of the routed outputs and
its sum with the shared expert's, cast to bf16 once; the angle head. With
``dtype`` None everything is in the parameters' dtype.

Spans (``tracing``): ``mla.attention``, ``moe.route`` (scores, top-k,
sort, offsets, the balance statistics) and ``moe.experts`` (gather,
grouped products, combine). While spans are live each expert layer adds
its routed real residues per expert to the counter ``moe.load.<layer>``.

Not supported, each with an error: tensor parallelism, data parallelism
(the loads are one device's), the flash attention branch, dropout and
reference-checkpoint import (the reference's checkpoints hold no such
model).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from protein_transformer_tpu_torch import tracing
from protein_transformer_tpu_torch.models.encoder_only import AngleProjection
from protein_transformer_tpu_torch.models.transformer import (
    Dense, cast, materialised_attention)

class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + eps) * weight, statistics and scale in fp32 on
    the input promoted to fp32; the result in ``dtype`` (None: fp32)."""

    def __init__(self, dim: int, eps: float, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.rms_norm(x.float(), (x.shape[-1],), self.weight, self.eps)
        return cast(y, self.dtype)


def rope_tables(max_len: int, dim: int, theta: float):
    """(cos, sin), each (max_len, dim / 2) fp32: the angle of pair i at
    position t is t theta^(-2i / dim)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32)
                             / dim))
    ang = torch.outer(torch.arange(max_len, dtype=torch.float32), freqs)
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate the adjacent pairs (x_2i, x_2i+1) of (..., L, dim) by the
    angles of positions 0..L-1, in fp32."""
    pairs = x.float().unflatten(-1, (-1, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    return torch.stack((a * cos - b * sin, a * sin + b * cos),
                       dim=-1).flatten(-2)


class MLAttention(nn.Module):
    """Multi-head latent attention without a query compression
    (q_lora_rank null)."""

    def __init__(self, dim: int, n_heads: int, arch: dict, max_len: int,
                 dtype=None):
        super().__init__()
        self.n_heads = n_heads
        self.dn, self.dr = arch["qk_nope_head_dim"], arch["qk_rope_head_dim"]
        self.dv, self.rank = arch["v_head_dim"], arch["kv_lora_rank"]
        self.dtype = dtype
        self.q_proj = Dense(dim, n_heads * (self.dn + self.dr), dtype,
                            bias=False)
        self.kv_a_proj_with_mqa = Dense(dim, self.rank + self.dr, dtype,
                                        bias=False)
        self.kv_a_layernorm = RMSNorm(self.rank, arch["rms_norm_eps"], dtype)
        self.kv_b_proj = Dense(self.rank, n_heads * (self.dn + self.dv),
                               dtype, bias=False)
        self.o_proj = Dense(n_heads * self.dv, dim, dtype, bias=False)
        cos, sin = rope_tables(max_len, self.dr, arch["rope_theta"])
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        bsz, length, _ = x.shape
        h, dn, dr, dv = self.n_heads, self.dn, self.dr, self.dv
        cos, sin = self.cos[:length], self.sin[:length]
        q = self.q_proj(x).view(bsz, length, h, dn + dr).transpose(1, 2)
        q_nope, q_pe = q.split([dn, dr], dim=-1)
        c_kv, k_pe = self.kv_a_proj_with_mqa(x).split([self.rank, dr],
                                                      dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c_kv))
        kv = kv.view(bsz, length, h, dn + dv).transpose(1, 2)
        k_nope, v = kv.split([dn, dv], dim=-1)
        q = torch.cat([q_nope, cast(rope(q_pe, cos, sin), self.dtype)], -1)
        k_pe = cast(rope(k_pe, cos, sin), self.dtype)[:, None]
        k = torch.cat([k_nope, k_pe.expand(bsz, h, length, dr)], -1)
        out = materialised_attention(q, k, v, mask, self.dtype)
        return self.o_proj(out.transpose(1, 2).reshape(bsz, length, h * dv))


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)), no biases."""

    def __init__(self, dim: int, hidden: int, dtype=None):
        super().__init__()
        self.gate_proj = Dense(dim, hidden, dtype, bias=False)
        self.up_proj = Dense(dim, hidden, dtype, bias=False)
        self.down_proj = Dense(hidden, dim, dtype, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(nn.Module):
    """The scores' projection and the correction bias of the selection."""

    def __init__(self, dim: int, n_experts: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_experts, dim))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(n_experts))


class Experts(nn.Module):
    """The routed experts' SwiGLU matrices, stacked (E, out, in): expert e's
    gate_proj, up_proj and down_proj are ``gate_proj[e]``, ..."""

    def __init__(self, dim: int, hidden: int, n_experts: int):
        super().__init__()
        # drawn by the trainer (or a checkpoint); no init here, which would
        # cost seconds on the CPU at the published widths
        self.gate_proj = nn.Parameter(torch.empty(n_experts, hidden, dim))
        self.up_proj = nn.Parameter(torch.empty(n_experts, hidden, dim))
        self.down_proj = nn.Parameter(torch.empty(n_experts, dim, hidden))


def grouped(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor, dtype):
    """Rows of x times each group's w[e]^T: rows up to offs[0] take expert
    0, up to offs[1] expert 1, ...; offs stays on the device."""
    return torch._grouped_mm(x, cast(w, dtype).transpose(-2, -1), offs=offs)


class MoE(nn.Module):
    """Shared plus routed SwiGLU experts under a sigmoid router."""

    def __init__(self, name: str, dim: int, arch: dict, dtype=None):
        super().__init__()
        self.name = name
        self.k = arch["num_experts_per_tok"]
        self.n_experts = arch["n_routed_experts"]
        self.scale = arch["routed_scaling_factor"]
        self.alpha = arch["seq_aux_alpha"]
        self.dtype = dtype
        hidden = arch["moe_intermediate_size"]
        self.gate = Router(dim, self.n_experts)
        self.experts = Experts(dim, hidden, self.n_experts)
        self.shared_experts = SwiGLU(dim, hidden * arch["n_shared_experts"],
                                     dtype)
        # the model's name of the correction bias
        self.bias_name = f"{name}.mlp.gate.e_score_correction_bias"

    def route(self, x: torch.Tensor):
        """(selected experts (T, k), their weights (T, k) fp32, scores
        (T, E) fp32) of the tokens x (T, d)."""
        s = torch.sigmoid(F.linear(x.float(), self.gate.weight))
        sel = self.select(s)
        g = s.gather(1, sel)
        g = g / g.sum(-1, keepdim=True)
        return sel, g * self.scale, s

    def select(self, s: torch.Tensor) -> torch.Tensor:
        """Each token's experts (T, k): the top k of s + b."""
        return torch.topk(s.detach() + self.gate.e_score_correction_bias,
                          self.k, dim=-1).indices

    def balance(self, sel, s, real):
        """(alpha sum_i f_i P_i averaged over the real proteins, the routed
        real residues per expert (E,)); real (B, L) bool."""
        bsz, length = real.shape
        e = self.n_experts
        r = real.reshape(-1, 1).float()
        hits = torch.zeros_like(s).scatter_(1, sel, 1.0) * r
        hits = hits.view(bsz, length, e).sum(1)                 # (B, E)
        share = (s / s.sum(-1, keepdim=True) * r).view(bsz, length, e)
        n = real.sum(1, keepdim=True).float()
        per = (hits * e / (self.k * n.clamp(min=1))
               * (share.sum(1) / n.clamp(min=1))).sum(-1)
        proteins = (n[:, 0] > 0).float()
        loss = self.alpha * (per * proteins).sum() / proteins.sum().clamp(
            min=1)
        return loss, hits.sum(0)

    def dispatch(self, sel: torch.Tensor):
        """(the sorted row of each assignment (T k,), the token of each
        sorted row (T k,), the groups' end offsets (E,) int32): the
        assignments sorted by expert, all on the device."""
        flat = sel.reshape(-1)
        order = torch.argsort(flat, stable=True)
        ids = torch.arange(self.n_experts, device=sel.device)
        offs = torch.searchsorted(flat[order], ids, right=True)
        rows = torch.arange(len(flat), device=sel.device)
        slot = torch.empty_like(order).scatter_(0, order, rows)
        return slot, order // self.k, offs.to(torch.int32)

    def forward(self, u: torch.Tensor, real: torch.Tensor) -> tuple:
        """(the layer's output, its balance term, its routed real residues
        per expert) for u (B, L, d)."""
        bsz, length, dim = u.shape
        x = u.reshape(-1, dim)
        with tracing.span("moe.route"):
            sel, g, s = self.route(x)
            loss, load = self.balance(sel, s, real)
            load = load.detach()
            tracing.count(f"moe.load.{self.name}", load)
            slot, token, offs = self.dispatch(sel)
        with tracing.span("moe.experts"):
            xs = x[token]
            w = self.experts
            hid = (F.silu(grouped(xs, w.gate_proj, offs, self.dtype))
                   * grouped(xs, w.up_proj, offs, self.dtype))
            y = grouped(hid, w.down_proj, offs, self.dtype)
            routed = (y[slot].view(-1, self.k, dim) * g[..., None]).sum(1)
            out = cast(routed.view(bsz, length, dim) + self.shared_experts(u),
                       self.dtype)
        return out, loss, load


class DecoderLayer(nn.Module):
    """RMSNorm -> MLA -> residual, RMSNorm -> SwiGLU or MoE -> residual."""

    def __init__(self, index: int, dim: int, d_ff: int, n_heads: int,
                 arch: dict, max_len: int, dtype=None):
        super().__init__()
        eps = arch["rms_norm_eps"]
        self.input_layernorm = RMSNorm(dim, eps, dtype)
        self.self_attn = MLAttention(dim, n_heads, arch, max_len, dtype)
        self.post_attention_layernorm = RMSNorm(dim, eps, dtype)
        self.mlp = (SwiGLU(dim, d_ff, dtype)
                    if index < arch["first_k_dense_replace"]
                    else MoE(f"layers.{index}", dim, arch, dtype))

    def forward(self, x, mask, real):
        with tracing.span("mla.attention"):
            x = x + self.self_attn(self.input_layernorm(x), mask)
        u = self.post_attention_layernorm(x)
        if isinstance(self.mlp, MoE):
            y, loss, load = self.mlp(u, real)
            return x + y, (loss, load)
        return x + self.mlp(u), None


class MLAMoETransformer(nn.Module):
    """'mla-moe' model family: ids (B, L) -> angles (B, L, 24)."""

    # set_model_parallel raises for this family
    tensor_parallel = False
    # the trainer leaves the parameters (the template of its state) on the
    # host and puts the buffers on the device
    template_on_host = True

    def __init__(self, n_layers: int, n_heads: int, d_model: int, d_ff: int,
                 max_len: int, vocab_size: int, angle_means, arch: dict,
                 use_tanh_out: bool = True, pad_id: int = 20, dtype=None):
        super().__init__()
        self.pad_id = pad_id
        self.dtype = dtype
        self.bias_update_speed = arch["bias_update_speed"]
        self.embed_tokens = nn.Embedding(vocab_size, d_model)
        self.layers = nn.ModuleList(
            DecoderLayer(i, d_model, d_ff, n_heads, arch, max_len, dtype)
            for i in range(n_layers))
        self.norm = RMSNorm(d_model, arch["rms_norm_eps"], dtype)
        self.head = AngleProjection(d_model, angle_means, use_tanh_out)
        # the last forward's (balance term of the objective, {correction
        # bias name: routed real residues per expert})
        self.balance: tuple | None = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        real = ids != self.pad_id
        mask = real[:, None, None, :]
        x = F.embedding(ids, cast(self.embed_tokens.weight, self.dtype))
        total, loads = torch.zeros((), device=ids.device), {}
        for layer in self.layers:
            x, aux = layer(x, mask, real)
            if aux is not None:
                total = total + aux[0]
                loads[layer.mlp.bias_name] = aux[1]
        self.balance = (total, loads)
        return self.head(self.norm(x))

    @torch.no_grad()
    def update_buffers(self, buffers: dict) -> None:
        """b_i += gamma sign(mean load - load_i) on each expert layer's
        correction bias in ``buffers`` (by name, updated in place), from
        the loads of the last forward: call after each optimizer step."""
        for name, load in self.balance[1].items():
            buffers[name].add_(torch.sign(load.mean() - load),
                               alpha=self.bias_update_speed)
