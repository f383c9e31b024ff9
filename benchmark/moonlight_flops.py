"""Operation counts of the 'mla-moe' trunk, the yardstick of
``moe_step_mfu.train`` and ``moe_gemm_roofline.train``: the matrix products
of the configuration's published widths (``d_model``, ``n_heads``,
``d_ff``, ``n_layers`` and the ``mla_moe`` keys). One (m, n) x (n, k)
product is 2 m n k operations; a training step is three times its forward
(the backward computes the gradients of both operands). Per layer: the MLA
projections (W_q, W_kva, W_kvb, W_o), Q K^T at D_qk = nope + rope and P V
at D_v; then the dense SwiGLU (the first ``first_k_dense_replace``
layers) or the router, the shared experts and ``num_experts_per_tok``
routed experts a token; then the angle head. The NeRF, the losses, the
norms and the softmax are not counted.
"""
from __future__ import annotations


def forward_flops(spec: dict, b: int, length: int) -> float:
    """The forward's matrix-product operations over b rows of ``length``
    tokens, every token computed."""
    a = spec["mla_moe"]
    d, h, t = spec["d_model"], spec["n_heads"], b * length
    dn, dr, dv = a["qk_nope_head_dim"], a["qk_rope_head_dim"], a["v_head_dim"]
    r, f = a["kv_lora_rank"], a["moe_intermediate_size"]
    proj = 2 * t * (d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv)
                    + h * dv * d)
    core = 2 * b * h * length * length * (dn + dr + dv)
    dense = 2 * t * 3 * d * spec["d_ff"]
    moe = 2 * t * (d * a["n_routed_experts"]
                   + 3 * d * f * (a["n_shared_experts"]
                                  + a["num_experts_per_tok"]))
    n_dense = a["first_k_dense_replace"]
    n_moe = spec["n_layers"] - n_dense
    return float(spec["n_layers"] * (proj + core) + n_dense * dense
                 + n_moe * moe + 2 * t * d * 24)


def train_flops_real(spec: dict, lens) -> float:
    """A training step's operations at each real protein's own length."""
    return sum(3.0 * forward_flops(spec, 1, int(n)) for n in lens)
