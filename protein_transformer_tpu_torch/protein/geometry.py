"""All-atom structure building (angles -> cartesian coordinates) in PyTorch.

Port of protein_transformer_tpu/protein/geometry.py, written batched over
(B, L) rather than per protein under vmap:

1. Backbone mainchain (N, CA, C) * L: one NeRF chain of 3L-3 extensions,
   composed with a doubling prefix scan (``ops.nerf.chain_positions_grouped``).
2. Carbonyl oxygens: one independent NeRF placement per residue.
3. Sidechains: up to 10 chained NeRF placements per residue, driven by the
   dense AMBER ff14SB tables (``protein._ff14sb``), sequential only over
   the slots: one hand-written CUDA kernel on a CUDA device, plain tensor
   ops elsewhere (``ops.sidechain``, chosen by ``sidechain_impl``).

Conventions are the JAX package's: angles (B, L, 12) radians in the order
[phi, psi, omega, theta1, theta2, theta3, chi0..chi5]; output (B, L, 14, 3)
with unused atom slots zero; the first residue's first sidechain atom is
framed by (next-N, C, CA).
"""
from __future__ import annotations

import math

import torch

from protein_transformer_tpu_torch.protein import _ff14sb as ff
from protein_transformer_tpu_torch.protein.constants import (
    NUM_PREDICTED_ANGLES)
from protein_transformer_tpu_torch.ops import sidechain
from protein_transformer_tpu_torch.ops.nerf import (
    chain_positions_grouped, device_constant, frame_from_points, nerf)

_L_CN = ff.BB_CONST["c-n"]
_L_NCA = ff.BB_CONST["n-ca"]
_L_CAC = ff.BB_CONST["ca-c"]
_L_CO = ff.BB_CONST["c-o"]
_ANG_CACO = ff.BB_CONST["ca-c-o"]


def build_backbone(angles: torch.Tensor) -> torch.Tensor:
    """(B, L, 12) radians -> (B, L, 4, 3): N, CA, C, O per residue."""
    bsz, length = angles.shape[:2]
    dtype, device = angles.dtype, angles.device

    # Seed residue 0 in the z=.001 plane. The constants are made once per
    # (device, dtype): a copy per call would wait on the stream.
    n0 = device_constant((0.0, 0.0, 0.001), device, dtype).expand(bsz, 3)
    ca0 = n0 + device_constant((_L_NCA, 0.0, 0.0), device, dtype)
    t13 = math.pi - angles[:, 0, 3]
    c0 = ca0 + _L_CAC * torch.stack(
        [torch.cos(t13), torch.sin(t13), torch.zeros_like(t13)], dim=-1)

    # Extensions for residues 1..L-1, three atoms each:
    #   N_i : len c-n,  theta = ang_{i-1}[4], chi = psi_{i-1}
    #   CA_i: len n-ca, theta = ang_{i-1}[5], chi = omega_{i-1}
    #   C_i : len ca-c, theta = ang_i[3],     chi = phi_i
    prev, cur = angles[:, :-1], angles[:, 1:]
    thetas = torch.stack([prev[..., 4], prev[..., 5], cur[..., 3]], dim=-1)
    chis = torch.stack([prev[..., 1], prev[..., 2], cur[..., 0]], dim=-1)
    lengths = device_constant((_L_CN, _L_NCA, _L_CAC), device,
                              dtype).expand(bsz, length - 1, 3)

    r0 = frame_from_points(n0, ca0, c0)
    ext = chain_positions_grouped(r0, c0, lengths, thetas, chis)
    mainchain = torch.cat([torch.stack([n0, ca0, c0], dim=1)[:, None], ext],
                          dim=1)  # (B, L, 3, 3)
    n, ca, c = mainchain[:, :, 0], mainchain[:, :, 1], mainchain[:, :, 2]

    # Oxygens: nerf(N, CA, C, c-o, ca-c-o, psi - pi) for every residue.
    o = nerf(n, ca, c, _L_CO, _ANG_CACO, angles[..., 1] - math.pi)
    return torch.cat([mainchain, o[:, :, None]], dim=2)


def build_sidechains(bb: torch.Tensor, angles: torch.Tensor,
                     seq: torch.Tensor,
                     sidechain_impl: str = "auto") -> torch.Tensor:
    """Sidechain atoms given the backbone.

    bb: (B, L, 4, 3); angles: (B, L, 12); seq: (B, L) amino-acid ids.
    sidechain_impl: "cuda" (the kernels: one K2a launch, which looks up the
    force-field tables itself), "torch" (plain tensor ops) or "auto" (by
    device), see ``ops.sidechain.build_sidechains``; the JAX package selects
    the same through PTT_SIDECHAIN_IMPL. Returns (B, L, 14, 3), unused slots
    zero."""
    return sidechain.build_sidechains(bb, angles, seq, impl=sidechain_impl)


def build_coords_batch(angles: torch.Tensor, seq: torch.Tensor,
                       sidechain_impl: str = "auto") -> torch.Tensor:
    """All-atom coordinates: (B, L, 12) + (B, L) -> (B, L, 14, 3)."""
    return build_sidechains(build_backbone(angles), angles, seq,
                            sidechain_impl)


def build_coords(angles: torch.Tensor, seq: torch.Tensor,
                 sidechain_impl: str = "auto") -> torch.Tensor:
    """One protein: (L, 12) + (L,) -> (L, 14, 3)."""
    return build_coords_batch(angles[None], seq[None], sidechain_impl)[0]


def inverse_trig_transform(sincos: torch.Tensor) -> torch.Tensor:
    """(..., L, 24) interleaved [cos, sin] pairs -> (..., L, 12) radians."""
    shaped = sincos.reshape(*sincos.shape[:-1], NUM_PREDICTED_ANGLES, 2)
    return torch.atan2(shaped[..., 1], shaped[..., 0])


def trig_transform(radians: torch.Tensor) -> torch.Tensor:
    """(..., L, 12) radians -> (..., L, 24) interleaved [cos, sin] pairs."""
    stacked = torch.stack([torch.cos(radians), torch.sin(radians)], dim=-1)
    return stacked.reshape(*radians.shape[:-1], NUM_PREDICTED_ANGLES * 2)
