"""The 'mla-moe' model (Moonlight-16B-A3B's layers as the trunk) in plain
PyTorch: the reference of the configurations whose program is that family.

It follows DeepSeek-V3 (arXiv:2412.19437, section 2.1) and the published
config's keys, which the configuration carries under ``mla_moe``, with the
benchmark's stated departures: the 22 amino-acid ids embedded by a plain
lookup; per layer h = x + MLA(RMSNorm(x)), y = h + FFN(RMSNorm(h)); the
first ``first_k_dense_replace`` FFNs a SwiGLU of d_ff, the rest MoE; a
final RMSNorm (x rsqrt(mean x^2 + eps) w) and the angle head
Linear(d_model -> 24) under tanh.

* MLA: q = W_q x, per head [q_nope, q_pe]; [c_kv, k_pe] = W_kva x;
  [k_nope, v] = W_kvb RMSNorm(c_kv) per head; RoPE in the reference code's
  complex form on adjacent pairs of q_pe and of the single k_pe (theta
  ``rope_theta``, positions 0..L-1), k_pe shared by the heads; softmax((q
  k^T) / sqrt(D_qk)) over the keys that are not padding (bidirectional),
  times v, then W_o.
* MoE: s = sigmoid(W_g u); each token's experts the top k of s + b (b the
  correction bias, no gradient); g = s_sel / sum s_sel x
  ``routed_scaling_factor``; out = SwiGLU_shared(u) + sum_k g_k
  SwiGLU_{e_k}(u), expert by expert over the tokens routed to it: every
  assignment computed.
* Balance (over real residues): the objective adds alpha sum_i f_i P_i per
  protein (f_i = E / (k T) x its residues routed to i, P_i the mean of
  s_i / sum_j s_j over its residues), summed over the expert layers and
  averaged over the proteins that have residues; after each optimizer
  step b_i += gamma sign(mean load - load_i), the loads the step's routed
  real residues per expert.

**Precision** is the configuration's ``compute_dtype``, with TF32 off
throughout. float32: everything in fp32. bfloat16, the published
precision: parameters, gradients and Adam in fp32; every product takes
bf16 operands and rounds its result to bf16; the residual stream is bf16.
In fp32, each on bf16 values promoted: the RMSNorm statistics and scale
(the result rounded to bf16), RoPE (likewise), the attention scores, mask
and softmax (the probabilities rounded to bf16 for P v), the router (W_g u,
the sigmoid, the selection and the weights), the weighted sum of a token's
routed outputs over its k slots plus the shared experts' output (rounded
to bf16 once), the angle head and the loss.

**The order of operations.** ``forward`` (an expert at a time, RoPE in
complex form) is the family's plain definition, which the CPU tests hold
the program to. ``program_forward``, which ``train_steps``
and ``score`` run, computes the same equations over the whole batch with
each operation as the program states it (``models/mla_moe.py``: the same
products on the same shapes, RoPE's real form on tables made on the host,
``F.rms_norm``, the sort by expert and ``torch._grouped_mm``). At bf16 the
difference matters: among 64 experts at initialisation the sixth and
seventh scores of many residues lie within a rounding of each other (bf16
against fp32, 6% to 28% of the residues of expert layers 1-4 choose
differently on the H100), and there two bf16 computations with the same
experts whose roundings differ read first gradients 4% to 7% apart in
norm. The loss after the trunk (NeRF, dRMSD, MSE, the balance term)
is the reference's own plain fp32, taken ``LOSS_ROWS`` rows at a time.

``train_steps`` runs each step's forward and backward over the whole
batch, each layer recomputed in the backward, and the optimizer of
``reference.train`` with Adam's moments on the host. It returns the first
gradient, the parameters' change over all the steps and the loss of the
first step alone (``losses`` holds one entry, so ``correct.py`` compares
that step's; ``step_losses`` holds every step's): after one update the
program's weights and these may round to bf16 copies that differ in an
element, and at the near ties above a residue may then take another
expert, which its protein's attention spreads. ``fp8=True`` is the
precision control: every product of the trunk takes its operands rounded
to float8 e4m3 first (one scale a tensor, its largest magnitude to 448),
the gradient passed straight through.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference import geometry, losses
from benchmark.reference.train import (  # noqa: F401
    ADAM_B1, ADAM_B2, ADAM_EPS, METRICS, WEIGHT_DECAY, TrainReadings,
    batch_of, noam)

# rows of the batch whose loss is taken at a time: the plain dRMSD holds
# each protein's pair distances
LOSS_ROWS = 4
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
FP8_MAX = 448.0


@contextlib.contextmanager
def _fp32():
    """TF32 off for matrix products and cuDNN inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (amax -> 448), the
    gradient straight through."""
    if x.numel() == 0:
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


class _Named(nn.Module):
    """A container that only gives its children their parameter names."""


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


class RMSNorm(nn.Module):
    """x rsqrt(mean x^2 + eps) w in fp32 on x promoted, the result in
    ``dtype`` (None: fp32)."""

    def __init__(self, dim: int, eps: float, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps, self.dtype = eps, dtype

    def forward(self, x):
        x = x.float()
        return _cast(x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                                     + self.eps) * self.weight, self.dtype)


def _linear(dim_in: int, dim_out: int) -> nn.Linear:
    return nn.Linear(dim_in, dim_out, bias=False)


class Moonlight(nn.Module):
    def __init__(self, spec: dict):
        super().__init__()
        a = spec["mla_moe"]
        d, h = spec["d_model"], spec["n_heads"]
        self.spec, self.arch, self.h = spec, a, h
        self.pad_id = spec["pad_id"]
        self.dtype = DTYPES[spec["compute_dtype"]]
        self.rounding = False
        eps, dt = a["rms_norm_eps"], self.dtype
        dn, dr, dv = (a["qk_nope_head_dim"], a["qk_rope_head_dim"],
                      a["v_head_dim"])
        self.embed_tokens = nn.Embedding(spec["vocab_size"], d)
        self.layers = nn.ModuleList()
        for i in range(spec["n_layers"]):
            layer = _Named()
            layer.input_layernorm = RMSNorm(d, eps, dt)
            layer.post_attention_layernorm = RMSNorm(d, eps, dt)
            at = layer.self_attn = _Named()
            at.q_proj = _linear(d, h * (dn + dr))
            at.kv_a_proj_with_mqa = _linear(d, a["kv_lora_rank"] + dr)
            at.kv_a_layernorm = RMSNorm(a["kv_lora_rank"], eps, dt)
            at.kv_b_proj = _linear(a["kv_lora_rank"], h * (dn + dv))
            at.o_proj = _linear(h * dv, d)
            if i < a["first_k_dense_replace"]:
                layer.mlp = self._swiglu(d, spec["d_ff"])
            else:
                e, f = a["n_routed_experts"], a["moe_intermediate_size"]
                mlp = layer.mlp = _Named()
                mlp.gate = _Named()
                mlp.gate.weight = nn.Parameter(torch.empty(e, d))
                mlp.gate.register_buffer("e_score_correction_bias",
                                         torch.zeros(e))
                mlp.experts = _Named()
                mlp.experts.gate_proj = nn.Parameter(torch.empty(e, f, d))
                mlp.experts.up_proj = nn.Parameter(torch.empty(e, f, d))
                mlp.experts.down_proj = nn.Parameter(torch.empty(e, d, f))
                mlp.shared_experts = self._swiglu(
                    d, f * a["n_shared_experts"])
            self.layers.append(layer)
        self.norm = RMSNorm(d, eps, dt)
        self.head = _Named()
        self.head.output_projection = nn.Linear(d, 24)

    @staticmethod
    def _swiglu(d: int, hidden: int) -> nn.Module:
        m = _Named()
        m.gate_proj, m.up_proj = _linear(d, hidden), _linear(d, hidden)
        m.down_proj = _linear(hidden, d)
        return m

    # -- products: operands rounded to fp8 under the control, then to the
    # precision
    def _r(self, x):
        return fp8(x) if self.rounding else x

    def c(self, x):
        return _cast(x, self.dtype)

    def lin(self, x, w):
        return F.linear(self.c(self._r(x)), self.c(self._r(w)))

    def swiglu(self, m, x):
        return self.lin(F.silu(self.lin(x, m.gate_proj.weight))
                        * self.lin(x, m.up_proj.weight), m.down_proj.weight)

    def rope(self, x, length: int):
        """x (..., L, dr) rotated by the complex pairs of positions 0..L-1,
        in fp32, the result in the precision."""
        dr = x.shape[-1]
        freqs = 1.0 / (self.arch["rope_theta"] ** (
            torch.arange(0, dr, 2, dtype=torch.float32, device=x.device)
            / dr))
        t = torch.arange(length, dtype=torch.float32, device=x.device)
        cis = torch.polar(torch.ones(length, dr // 2, device=x.device),
                          torch.outer(t, freqs))
        z = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2))
        return self.c(torch.view_as_real(z * cis).flatten(-2))

    def attention(self, at, x, mask):
        a, h = self.arch, self.h
        b, length, _ = x.shape
        dn, dr, dv = (a["qk_nope_head_dim"], a["qk_rope_head_dim"],
                      a["v_head_dim"])
        q = self.lin(x, at.q_proj.weight).view(b, length, h, dn + dr)
        q = q.transpose(1, 2)
        kv = self.lin(x, at.kv_a_proj_with_mqa.weight)
        c_kv, k_pe = kv[..., :a["kv_lora_rank"]], kv[..., a["kv_lora_rank"]:]
        kv = self.lin(at.kv_a_layernorm(c_kv), at.kv_b_proj.weight)
        kv = kv.view(b, length, h, dn + dv).transpose(1, 2)
        q = torch.cat([q[..., :dn], self.rope(q[..., dn:], length)], -1)
        k_pe = self.rope(k_pe, length)[:, None].expand(b, h, length, dr)
        k = torch.cat([kv[..., :dn], k_pe], -1)
        s = torch.matmul(self._r(q.float()),
                         self._r(k.float()).transpose(-2, -1))
        s = s / math.sqrt(dn + dr)
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
        p = self.c(self._r(torch.softmax(s, dim=-1)))
        o = torch.matmul(p, self.c(self._r(kv[..., dn:])))
        return self.lin(o.transpose(1, 2).reshape(b, length, h * dv),
                        at.o_proj.weight)

    def select(self, mlp, s):
        """Each token's experts (T, k): the top k of s + b."""
        return torch.topk(s.detach() + mlp.gate.e_score_correction_bias,
                          self.arch["num_experts_per_tok"], dim=-1).indices

    # -- the experts' choice: the program's operations on the whole batch
    def _norm(self, m, x):
        return self.c(F.rms_norm(x.float(), (x.shape[-1],), m.weight,
                                 m.eps))

    def _rope_tables(self, device):
        dr = self.arch["qk_rope_head_dim"]
        freqs = 1.0 / (self.arch["rope_theta"] ** (
            torch.arange(0, dr, 2, dtype=torch.float32) / dr))
        ang = torch.outer(torch.arange(self.spec["max_seq_len"],
                                       dtype=torch.float32), freqs)
        return torch.cos(ang).to(device), torch.sin(ang).to(device)

    @staticmethod
    def _rope_pairs(x, cos, sin):
        pairs = x.float().unflatten(-1, (-1, 2))
        a, b = pairs[..., 0], pairs[..., 1]
        return torch.stack((a * cos - b * sin, a * sin + b * cos),
                           dim=-1).flatten(-2)

    def _grouped(self, x, w, offs):
        return torch._grouped_mm(self.c(self._r(x)),
                                 self.c(self._r(w)).transpose(-2, -1),
                                 offs=offs)

    def program_layer(self, layer, x, mask, cos, sin, real):
        """(the layer's output; its balance term per row and its routed real
        residues per expert, None for a dense layer), each operation as the
        program computes it (module docstring)."""
        a, h = self.arch, self.h
        dn, dr, dv = (a["qk_nope_head_dim"], a["qk_rope_head_dim"],
                      a["v_head_dim"])
        e, k, rank = (a["n_routed_experts"], a["num_experts_per_tok"],
                      a["kv_lora_rank"])
        b, length = x.shape[:2]
        at = layer.self_attn
        u = self._norm(layer.input_layernorm, x)
        q = self.lin(u, at.q_proj.weight).view(b, length, h, dn + dr)
        q_nope, q_pe = q.transpose(1, 2).split([dn, dr], dim=-1)
        c_kv, k_pe = self.lin(u, at.kv_a_proj_with_mqa.weight).split(
            [rank, dr], dim=-1)
        kv = self.lin(self._norm(at.kv_a_layernorm, c_kv),
                      at.kv_b_proj.weight)
        k_nope, v = kv.view(b, length, h, dn + dv).transpose(1, 2).split(
            [dn, dv], dim=-1)
        q = torch.cat([q_nope, self.c(self._rope_pairs(q_pe, cos, sin))], -1)
        k_pe = self.c(self._rope_pairs(k_pe, cos, sin))[:, None]
        kk = torch.cat([k_nope, k_pe.expand(b, h, length, dr)], -1)
        qf, kf = q.float(), kk.float()
        sc = torch.matmul(self._r(qf), self._r(kf).transpose(-2, -1))
        sc = sc / math.sqrt(qf.shape[-1])
        sc = sc.masked_fill(~mask, torch.finfo(torch.float32).min)
        p = self.c(self._r(torch.softmax(sc, dim=-1)))
        o = torch.matmul(p, self.c(self._r(v)))
        x = x + self.lin(o.transpose(1, 2).reshape(b, length, h * dv),
                         at.o_proj.weight)
        u = self._norm(layer.post_attention_layernorm, x)
        mlp = layer.mlp
        if not hasattr(mlp, "experts"):
            return x + self.swiglu(mlp, u), None, None
        t = u.reshape(-1, u.shape[-1])
        s = torch.sigmoid(F.linear(self._r(t.float()),
                                   self._r(mlp.gate.weight)))
        sel = self.select(mlp, s)
        g = s.gather(1, sel)
        g = g / g.sum(-1, keepdim=True)
        g = g * a["routed_scaling_factor"]
        flat = sel.reshape(-1)
        order = torch.argsort(flat, stable=True)
        offs = torch.searchsorted(
            flat[order], torch.arange(e, device=t.device),
            right=True).to(torch.int32)
        slot = torch.empty_like(order).scatter_(
            0, order, torch.arange(len(flat), device=t.device))
        xs = t[order // k]
        ex = mlp.experts
        hid = (F.silu(self._grouped(xs, ex.gate_proj, offs))
               * self._grouped(xs, ex.up_proj, offs))
        y = self._grouped(hid, ex.down_proj, offs)
        routed = (y[slot].view(-1, k, t.shape[-1]) * g[..., None]).sum(1)
        x = x + self.c(routed.view(u.shape)
                       + self.swiglu(mlp.shared_experts, u))
        per, load = self.balance_stats(s, sel, real)
        return x, per, load

    def program_forward(self, ids):
        """``forward`` of the whole batch, each operation as the program
        computes it (module docstring); under autograd each layer is
        recomputed in the backward."""
        real = ids != self.pad_id
        mask = real[:, None, None, :]
        cos, sin = (t[:ids.shape[1]] for t in self._rope_tables(ids.device))
        x = F.embedding(ids, self.c(self.embed_tokens.weight))
        balance = torch.zeros(ids.shape[0], device=ids.device)
        loads = []
        for layer in self.layers:
            args = (layer, x, mask, cos, sin, real)
            if torch.is_grad_enabled():
                x, per, load = checkpoint(self.program_layer, *args,
                                          use_reentrant=False)
            else:
                x, per, load = self.program_layer(*args)
            if load is not None:
                balance = balance + self.arch["seq_aux_alpha"] * per
                loads.append(load)
        out = self.head.output_projection(self._norm(self.norm, x).float())
        return torch.tanh(out), balance, loads

    def balance_stats(self, s, sel, real):
        """(each row's sum_i f_i P_i over its real residues (B,), the
        routed real residues per expert (E,))."""
        b, length = real.shape
        e, k = self.arch["n_routed_experts"], self.arch["num_experts_per_tok"]
        r = real.reshape(-1).float()
        onehot = torch.zeros_like(s).scatter(1, sel, 1.0) * r[:, None]
        count = onehot.view(b, length, e).sum(1)
        n = real.sum(1).float().clamp(min=1)
        f = count * e / (k * n[:, None])
        p = ((s / s.sum(-1, keepdim=True)) * r[:, None]).view(
            b, length, e).sum(1) / n[:, None]
        return (f * p).sum(-1), count.sum(0)

    def moe(self, mlp, u, real):
        """(output, balance term, routed real residues per expert)."""
        a = self.arch
        b, length, d = u.shape
        e, k = a["n_routed_experts"], a["num_experts_per_tok"]
        x = u.reshape(-1, d)
        s = torch.sigmoid(F.linear(self._r(x.float()),
                                   self._r(mlp.gate.weight)))
        sel = self.select(mlp, s)
        g = s.gather(1, sel)
        g = g / g.sum(-1, keepdim=True) * a["routed_scaling_factor"]
        # expert by expert over its (token, slot) assignments, the outputs
        # put back in (token, slot) order
        flat = sel.reshape(-1)
        ex, outs, rows = mlp.experts, [], []
        for i in range(e):
            at = torch.nonzero(flat == i).reshape(-1)
            xi = x[at // k]
            hid = (F.silu(self.lin(xi, ex.gate_proj[i]))
                   * self.lin(xi, ex.up_proj[i]))
            outs.append(self.lin(hid, ex.down_proj[i]))
            rows.append(at)
        y = torch.cat(outs)[torch.argsort(torch.cat(rows))].view(-1, k, d)
        out = self.c((y * g[..., None]).sum(1)
                     + self.swiglu(mlp.shared_experts, x))
        per, load = self.balance_stats(s, sel, real)
        return out.view(b, length, d), per, load

    def forward(self, ids):
        """(angles (B, L, 24), the balance term of each row summed over the
        expert layers (B,), [routed real residues per expert of each expert
        layer])."""
        real = ids != self.pad_id
        mask = real[:, None, None, :]
        x = self.c(self.embed_tokens(ids))
        balance = torch.zeros(ids.shape[0], device=ids.device)
        loads = []
        for layer in self.layers:
            if torch.is_grad_enabled():
                # recomputed in the backward: one layer's activations and
                # bf16 weight copies live at a time
                x, per, load = checkpoint(self.layer, layer, x, mask, real,
                                          use_reentrant=False)
            else:
                x, per, load = self.layer(layer, x, mask, real)
            if load is not None:
                balance = balance + self.arch["seq_aux_alpha"] * per
                loads.append(load)
        out = self.head.output_projection(self.norm(x).float())
        return torch.tanh(out), balance, loads

    def layer(self, layer, x, mask, real):
        """(the layer's output; its balance term and loads, None for a
        dense layer)."""
        x = x + self.attention(layer.self_attn, layer.input_layernorm(x),
                               mask)
        u = layer.post_attention_layernorm(x)
        if not hasattr(layer.mlp, "experts"):
            return x + self.swiglu(layer.mlp, u), None, None
        y, per, load = self.moe(layer.mlp, u, real)
        return x + y, per, load

    @torch.no_grad()
    def update_bias(self, loads: list) -> None:
        gamma = self.arch["bias_update_speed"]
        moes = [lay.mlp for lay in self.layers if hasattr(lay.mlp, "experts")]
        for mlp, load in zip(moes, loads):
            mlp.gate.e_score_correction_bias.add_(
                gamma * torch.sign(load.mean() - load))


def build(spec: dict) -> Moonlight:
    return Moonlight(spec)


def model_of(spec: dict, weights: dict, device) -> Moonlight:
    model = build(spec).to(device)
    names = dict(model.named_parameters())
    if set(names) != set(weights):
        raise ValueError("the weights do not name the model's parameters: "
                         f"{sorted(set(names) ^ set(weights))[:4]}")
    with torch.no_grad():
        for k, p in names.items():
            p.copy_(weights[k])
    return model


def _drop_half(batch: dict) -> dict:
    """A planted fault: the second half of the real proteins left out of
    the losses, the means taken over the rest."""
    pm = batch["protein_mask"]
    n = int(pm.sum())
    keep = torch.arange(pm.shape[0], device=pm.device) < max(1, n // 2)
    return {**batch, "protein_mask": pm & keep,
            "ang_mask": batch["ang_mask"] & keep[:, None, None],
            "crd_mask": batch["crd_mask"] & keep[:, None, None]}


def _rows(batch: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in batch.items()}


def objective(pred, blk: dict, spec: dict, n_ang, n_prot):
    """The combined loss of the block's rows of ``pred``: its sums over
    the whole batch's counts (valid angle entries, real proteins)."""
    if spec["loss"] != "combined":
        raise ValueError("the reference follows the combined loss")
    crd = geometry.coords(geometry.angles_from_sincos(pred), blk["seq"])
    b = pred.shape[0]
    sq = torch.where(blk["ang_mask"], (pred - blk["ang"]) ** 2, 0.0).sum()
    sl = slice(0, 3) if spec["backbone_loss"] else slice(None)
    m = blk["crd_mask"][:, :, sl].reshape(b, -1)
    dr = losses.drmsd(crd[:, :, sl].reshape(b, -1, 3),
                      blk["crd"][:, :, sl].reshape(b, -1, 3), m)
    ln = dr / torch.clamp(m.sum(-1), min=1)
    w = spec["combined_drmsd_weight"]
    return (w * torch.sum(ln * blk["protein_mask"]) / n_prot / 0.02
            + (1 - w) * sq / n_ang / 0.01)


@dataclasses.dataclass
class Readings(TrainReadings):
    """``losses``: the first step's alone, what ``correct.py`` compares
    (module docstring); ``step_losses``: every step's."""
    step_losses: list = dataclasses.field(default_factory=list)


def train_steps(spec: dict, weights: dict, batches: list, seed: int,
                device, drop_half: bool = False,
                fp8: bool = False) -> Readings:
    """The first len(batches) steps from ``weights`` (not changed); the
    first step's loss, the first gradient and the change on the host.
    ``seed``: no dropout draws from it (the family has none)."""
    with _fp32():
        model = model_of(spec, weights, device).train()
        model.rounding = fp8
        names = [k for k, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        # Adam's moments on the host: on the card they would not fit
        # beside the run's captures
        mu = [torch.zeros_like(p, device="cpu") for p in params]
        nu = [torch.zeros_like(p, device="cpu") for p in params]
        out = Readings([], {}, {})
        for step, batch in enumerate(batches, start=1):
            if drop_half:
                batch = _drop_half(batch)
            n_ang = torch.clamp(batch["ang_mask"].sum(), min=1)
            n_prot = torch.clamp(batch["protein_mask"].sum(), min=1)
            rows = batch["seq"] != spec["pad_id"]
            n_rows = torch.clamp(rows.any(1).sum(), min=1)
            pred, balance, loads = model.program_forward(batch["seq"])
            balance = balance.sum() / n_rows
            loss = float(balance.detach())
            dpred = torch.zeros_like(pred)
            for lo in range(0, pred.shape[0], LOSS_ROWS):
                part_pred = pred.detach()[lo:lo + LOSS_ROWS].requires_grad_()
                part = objective(part_pred,
                                 _rows(batch, lo, lo + LOSS_ROWS), spec,
                                 n_ang, n_prot)
                part.backward()
                dpred[lo:lo + LOSS_ROWS] = part_pred.grad
                loss += float(part.detach())
                del part
            torch.autograd.backward([pred, balance], [dpred, None])
            del pred, dpred, balance
            grads = [p.grad for p in params]
            for p in params:
                p.grad = None
            out.step_losses.append(loss)
            if step == 1:
                out.losses.append(loss)
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                clip = spec["clip"]
                factor = 1.0 if float(norm) < clip else clip / float(norm)
                for g in grads:
                    g.mul_(factor)
                if step == 1:
                    out.grad1 = {k: g.to("cpu", copy=True)
                                 for k, g in zip(names, grads)}
                lr = noam(spec["d_model"], spec["n_warmup_steps"], step)
                for p, g, m_host, v_host in zip(params, grads, mu, nu):
                    g.add_(p, alpha=WEIGHT_DECAY)
                    m, v = m_host.to(device), v_host.to(device)
                    m.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                    v.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                    upd = ((m / (1 - ADAM_B1 ** step))
                           / (torch.sqrt(v / (1 - ADAM_B2 ** step))
                              + ADAM_EPS))
                    p.sub_(lr * upd)
                    m_host.copy_(m)
                    v_host.copy_(v)
                    del m, v, upd
                del grads
                model.update_bias([ld.detach() for ld in loads])
            del loads
        del mu, nu
        with torch.no_grad():
            out.change = {k: (p - weights[k]).cpu()
                          for k, p in zip(names, params)}
    return out


@torch.no_grad()
def score(spec: dict, weights: dict, batches: list, device,
          drop_half: bool = False) -> list:
    """Eval metrics (``METRICS`` order) of each batch, as float lists: the
    trunk over the whole batch, the metrics over the whole batch."""
    with _fp32():
        model = model_of(spec, weights, device).eval()
        rows = []
        for batch in batches:
            if drop_half:
                batch = _drop_half(batch)
            pred = model.program_forward(batch["seq"])[0]
            crd = geometry.coords(geometry.angles_from_sincos(pred),
                                  batch["seq"])
            m = losses.batch_metrics(pred, crd, batch, spec, True)
            rows.append([float(m[k]) for k in METRICS])
    return rows
