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

import numpy as np
import torch

from protein_transformer_tpu_torch.protein import _ff14sb as ff
from protein_transformer_tpu_torch.protein.constants import (
    NUM_PREDICTED_ANGLES, NUM_PREDICTED_COORDS, SC_ANGLES_START_POS)
from protein_transformer_tpu_torch.ops.nerf import (
    chain_positions_grouped, frame_from_points, nerf)
from protein_transformer_tpu_torch.ops.sidechain import (
    build_sidechain_points, build_sidechain_points_torch)

_L_CN = ff.BB_CONST["c-n"]
_L_NCA = ff.BB_CONST["n-ca"]
_L_CAC = ff.BB_CONST["ca-c"]
_L_CO = ff.BB_CONST["c-o"]
_ANG_CACO = ff.BB_CONST["ca-c-o"]


def build_backbone(angles: torch.Tensor) -> torch.Tensor:
    """(B, L, 12) radians -> (B, L, 4, 3): N, CA, C, O per residue."""
    bsz, length = angles.shape[:2]
    dtype, device = angles.dtype, angles.device

    # Seed residue 0 in the z=.001 plane.
    n0 = torch.tensor([0.0, 0.0, 0.001], dtype=dtype,
                      device=device).expand(bsz, 3)
    ca0 = n0 + torch.tensor([_L_NCA, 0.0, 0.0], dtype=dtype, device=device)
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
    lengths = torch.tensor([_L_CN, _L_NCA, _L_CAC], dtype=dtype,
                           device=device).expand(bsz, length - 1, 3)

    r0 = frame_from_points(n0, ca0, c0)
    ext = chain_positions_grouped(r0, c0, lengths, thetas, chis)
    mainchain = torch.cat([torch.stack([n0, ca0, c0], dim=1)[:, None], ext],
                          dim=1)  # (B, L, 3, 3)
    n, ca, c = mainchain[:, :, 0], mainchain[:, :, 1], mainchain[:, :, 2]

    # Oxygens: nerf(N, CA, C, c-o, ca-c-o, psi - pi) for every residue.
    o = nerf(n, ca, c, _L_CO, _ANG_CACO, angles[..., 1] - math.pi)
    return torch.cat([mainchain, o[:, :, None]], dim=2)


def _table(arr: np.ndarray, aa: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.as_tensor(arr, dtype=dtype, device=aa.device)[aa]


def sidechain_inputs(bb: torch.Tensor, angles: torch.Tensor,
                     seq: torch.Tensor) -> tuple:
    """What the slot chain takes besides the backbone, from the force-field
    tables: (anchor (B, L, 3), torsions, bond lengths, bond angles (B, L, 10),
    n_sc (B, L), frame indices (B, L, 10, 3))."""
    length = bb.shape[1]
    dtype = bb.dtype
    aa = torch.clamp(seq.long(), 0, ff.SC_NUM_ATOMS.shape[0] - 1)

    n_sc = _table(ff.SC_NUM_ATOMS, aa)                     # (B, L)
    blen = _table(ff.SC_BOND_LEN, aa, dtype)               # (B, L, 10)
    bang = _table(ff.SC_BOND_ANG, aa, dtype)
    ttype = _table(ff.SC_TORSION_TYPE, aa)
    tconst = _table(ff.SC_TORSION_CONST, aa, dtype)
    tsrc = _table(ff.SC_TORSION_SRC, aa).long()
    toff = _table(ff.SC_TORSION_PI_OFFSET, aa, dtype)
    frame = _table(ff.SC_FRAME_IDX, aa).long()             # (B, L, 10, 3)

    # Residue 0's first sidechain atom is framed by (next-N, C, CA) instead
    # of (prev-C, N, CA); both use buffer slot 14 as the anchor.
    frame[:, 0, 0] = torch.tensor([ff.ANCHOR_IDX, 2, 1], device=frame.device)

    # Anchor: N of residue 1 for residue 0, else C of residue i-1. A lone
    # residue (L=1) falls back to its own C so the build is defined.
    if length == 1:
        anchor = bb[:, :, 2]
    else:
        anchor = torch.cat([bb[:, 1:2, 0], bb[:, :-1, 2]], dim=1)

    # Torsions: predicted chi (indexed by source slot) or the chemical
    # constant, minus the pi offset of 'inferred' planar atoms.
    chi_idx = torch.clamp(SC_ANGLES_START_POS + tsrc, 0,
                          NUM_PREDICTED_ANGLES - 1)
    chi_vals = torch.gather(angles, -1, chi_idx)
    torsions = torch.where(ttype == ff.TORSION_PRED, chi_vals, tconst) - toff
    return anchor, torsions, blen, bang, n_sc, frame


def build_sidechains(bb: torch.Tensor, angles: torch.Tensor,
                     seq: torch.Tensor,
                     sidechain_impl: str = "auto") -> torch.Tensor:
    """Sidechain atoms given the backbone.

    bb: (B, L, 4, 3); angles: (B, L, 12); seq: (B, L) amino-acid ids.
    sidechain_impl: "cuda" (the kernels), "torch" (plain) or "auto" (by
    device), see ``ops.sidechain.build_sidechain_points``; the JAX package
    selects the same through PTT_SIDECHAIN_IMPL. Returns (B, L, 14, 3),
    unused slots zero."""
    return build_sidechain_points(bb, *sidechain_inputs(bb, angles, seq),
                                  impl=sidechain_impl)


# The slot chain in plain tensor ops, under the name it has had here.
build_sidechain_slots = build_sidechain_points_torch


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
