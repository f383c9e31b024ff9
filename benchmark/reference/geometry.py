"""Angles to all-atom coordinates in plain PyTorch: the benchmark's own NeRF.

A frozen copy of the plain path of the port's geometry, taken from commit
026902350ad78ec8349700d5f0a9d57ffc236aec
(``protein_transformer_tpu_torch/ops/nerf.py``, ``protein/geometry.py`` and
``ops/sidechain.py``'s ``sidechain_inputs`` and
``build_sidechain_points_torch``), with the force-field tables read straight
from ``ff14sb_tables.npz`` beside this file. It makes the true coordinates
of the benchmark's proteins and the reference's predicted ones; it imports
nothing of the port, so a later change to the port's geometry cannot move
it.

Conventions: angles (B, L, 12) radians in the order [phi, psi, omega,
theta1, theta2, theta3, chi0..chi5]; output (B, L, 14, 3), unused atom
slots zero. A float32 backbone chain is composed in float64.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

N_ANGLES = 12
N_ATOM_SLOTS = 14
SC_START = 6           # first sidechain angle
MAX_SC_ATOMS = 10
ANCHOR_IDX = 14
TORSION_PRED = 1
NORM_EPS = 1e-12

_TABLES = np.load(os.path.join(os.path.dirname(__file__),
                               "ff14sb_tables.npz"))
BB = {str(k): float(v) for k, v in zip(_TABLES["bb_names"],
                                       _TABLES["bb_values"])}
SC_NUM_ATOMS = np.asarray(_TABLES["sc_num_atoms"])
N_TYPES = SC_NUM_ATOMS.shape[0]


def sc_tables(device) -> dict:
    """The sidechain tables as tensors on ``device``, rows by residue id."""
    return {k: torch.as_tensor(np.asarray(_TABLES[k]), device=device)
            for k in ("sc_num_atoms", "sc_bond_len", "sc_bond_ang",
                      "sc_torsion_type", "sc_torsion_const", "sc_torsion_src",
                      "sc_torsion_pi_offset", "sc_frame_idx")}


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def normalize(v: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(n2, min=NORM_EPS * NORM_EPS))


def nerf(a, b, c, length, theta, chi):
    """The 4th atom from three frame atoms and internal coordinates."""
    w_hat = normalize(b - a)
    x_hat = normalize(c - b)
    z_hat = normalize(torch.linalg.cross(w_hat, x_hat, dim=-1))
    y_hat = torch.linalg.cross(z_hat, x_hat, dim=-1)
    if not isinstance(length, torch.Tensor):
        length = torch.full_like(a[..., 0], length)
    if not isinstance(theta, torch.Tensor):
        theta = torch.full_like(a[..., 0], theta)
    length, theta, chi = length[..., None], theta[..., None], chi[..., None]
    d = (-length * torch.cos(theta) * x_hat
         + length * torch.sin(theta) * torch.cos(chi) * y_hat
         + length * torch.sin(theta) * torch.sin(chi) * z_hat)
    return c + d


def _extension(length, theta, chi):
    ct, st = torch.cos(theta), torch.sin(theta)
    cx, sx = torch.cos(chi), torch.sin(chi)
    zeros = torch.zeros_like(ct)
    sg = torch.where(st < 0, -1.0, 1.0).to(ct.dtype)
    r = torch.stack([
        torch.stack([-ct, -sg * st, zeros], dim=-1),
        torch.stack([st * cx, -sg * ct * cx, -sg * sx], dim=-1),
        torch.stack([st * sx, -sg * ct * sx, sg * cx], dim=-1)], dim=-2)
    t = torch.stack([-length * ct, length * st * cx, length * st * sx],
                    dim=-1)
    return r, t


def _mm(m, x):
    return torch.sum(m[..., :, :, None] * x[..., None, :, :], dim=-2)


def _mv(m, v):
    return torch.sum(m * v[..., None, :], dim=-1)


def _compose(left, right):
    (ra, ta), (rb, tb) = left, right
    return _mm(ra, rb), ta + _mv(ra, tb)


def _prefix(r, t):
    k, shift = r.shape[-3], 1
    while shift < k:
        nr, nt = _compose((r[..., :-shift, :, :], t[..., :-shift, :]),
                          (r[..., shift:, :, :], t[..., shift:, :]))
        r = torch.cat([r[..., :shift, :, :], nr], dim=-3)
        t = torch.cat([t[..., :shift, :], nt], dim=-2)
        shift *= 2
    return r, t


def _chain(r0, t0, lengths, thetas, chis):
    """(..., K, G, 3) positions of K residue steps of G extensions."""
    if t0.dtype == torch.float32:
        return _chain(r0.double(), t0.double(), lengths.double(),
                      thetas.double(), chis.double()).float()
    r, t = _extension(lengths, thetas, chis)
    if lengths.shape[-2] == 0:
        return t0[..., None, None, :] + t
    cum = [(r[..., 0, :, :], t[..., 0, :])]
    for a in range(1, lengths.shape[-1]):
        cum.append(_compose(cum[-1], (r[..., a, :, :], t[..., a, :])))
    local_t = torch.stack([c[1] for c in cum], dim=-2)
    pr, pt = _prefix(*cum[-1])
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(
        *pr.shape[:-3], 1, 3, 3)
    pr_prev = torch.cat([eye, pr[..., :-1, :, :]], dim=-3)
    pt_prev = torch.cat([torch.zeros_like(pt[..., :1, :]), pt[..., :-1, :]],
                        dim=-2)
    local = pt_prev[..., :, None, :] + _mv(pr_prev[..., :, None, :, :],
                                           local_t)
    return t0[..., None, None, :] + _mv(r0[..., None, None, :, :], local)


def _frame(a, b, c):
    w_hat = normalize(b - a)
    x_hat = normalize(c - b)
    z_hat = normalize(torch.linalg.cross(w_hat, x_hat, dim=-1))
    y_hat = torch.linalg.cross(z_hat, x_hat, dim=-1)
    return torch.stack([x_hat, y_hat, z_hat], dim=-1)


def backbone(angles: torch.Tensor) -> torch.Tensor:
    """(B, L, 12) radians -> (B, L, 4, 3): N, CA, C, O."""
    bsz, length = angles.shape[:2]
    n0 = _const((0.0, 0.0, 0.001), angles).expand(bsz, 3)
    ca0 = n0 + _const((BB["n-ca"], 0.0, 0.0), angles)
    t13 = math.pi - angles[:, 0, 3]
    c0 = ca0 + BB["ca-c"] * torch.stack(
        [torch.cos(t13), torch.sin(t13), torch.zeros_like(t13)], dim=-1)
    prev, cur = angles[:, :-1], angles[:, 1:]
    thetas = torch.stack([prev[..., 4], prev[..., 5], cur[..., 3]], dim=-1)
    chis = torch.stack([prev[..., 1], prev[..., 2], cur[..., 0]], dim=-1)
    lengths = _const((BB["c-n"], BB["n-ca"], BB["ca-c"]), angles).expand(
        bsz, length - 1, 3)
    ext = _chain(_frame(n0, ca0, c0), c0, lengths, thetas, chis)
    main = torch.cat([torch.stack([n0, ca0, c0], dim=1)[:, None], ext], dim=1)
    o = nerf(main[:, :, 0], main[:, :, 1], main[:, :, 2], BB["c-o"],
             BB["ca-c-o"], angles[..., 1] - math.pi)
    return torch.cat([main, o[:, :, None]], dim=2)


def sidechains(bb: torch.Tensor, angles: torch.Tensor,
               seq: torch.Tensor) -> torch.Tensor:
    """(B, L, 14, 3): the backbone and up to 10 chained placements a
    residue, driven by the ff14SB tables; dead slots zero."""
    bsz, length = bb.shape[:2]
    dtype = bb.dtype
    tab = sc_tables(bb.device)
    aa = torch.clamp(seq.long(), 0, N_TYPES - 1)
    n_sc = tab["sc_num_atoms"][aa]
    blen = tab["sc_bond_len"][aa].to(dtype)
    bang = tab["sc_bond_ang"][aa].to(dtype)
    ttype = tab["sc_torsion_type"][aa]
    tconst = tab["sc_torsion_const"][aa].to(dtype)
    tsrc = tab["sc_torsion_src"][aa].long()
    toff = tab["sc_torsion_pi_offset"][aa].to(dtype)
    frame = tab["sc_frame_idx"][aa].long().clone()
    frame[:, 0, 0] = torch.tensor((ANCHOR_IDX, 2, 1), device=bb.device)
    anchor = (bb[:, :, 2] if length == 1 else
              torch.cat([bb[:, 1:2, 0], bb[:, :-1, 2]], dim=1))
    chi_idx = torch.clamp(SC_START + tsrc, 0, N_ANGLES - 1)
    chi = torch.gather(angles, -1, chi_idx)
    torsions = torch.where(ttype == TORSION_PRED, chi, tconst) - toff
    buf = torch.cat([bb, torch.zeros_like(bb[:, :, :1]).expand(
        bsz, length, MAX_SC_ATOMS, 3), anchor[:, :, None]], dim=2)
    for slot in range(MAX_SC_ATOMS):
        idx = frame[:, :, slot, :, None].expand(bsz, length, 3, 3)
        abc = torch.gather(buf, 2, idx)
        pt = nerf(abc[:, :, 0], abc[:, :, 1], abc[:, :, 2], blen[..., slot],
                  bang[..., slot], torsions[..., slot])
        pt = torch.where((slot < n_sc)[..., None], pt, 0.0)
        buf = torch.cat([buf[:, :, :4 + slot], pt[:, :, None],
                         buf[:, :, 5 + slot:]], dim=2)
    return buf[:, :, :N_ATOM_SLOTS]


def coords(angles: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """All-atom coordinates: (B, L, 12) + (B, L) ids -> (B, L, 14, 3)."""
    return sidechains(backbone(angles), angles, seq)


def angles_from_sincos(sincos: torch.Tensor) -> torch.Tensor:
    """(..., L, 24) interleaved [cos, sin] -> (..., L, 12) radians."""
    s = sincos.reshape(*sincos.shape[:-1], N_ANGLES, 2)
    return torch.atan2(s[..., 1], s[..., 0])
