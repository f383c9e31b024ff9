"""NeRF (natural extension reference frame) primitives in PyTorch.

Port of protein_transformer_tpu/ops/nerf.py. Chain extension is rigid-frame
algebra: ``extension_transform`` gives the local transform of one NeRF step
from (length, theta, chi) alone, and ``chain_positions_grouped`` composes
them with a prefix scan, so the backbone is built in O(log L) depth instead
of a 3L-step sequential loop.

The 3x3 products are written as broadcast multiply-and-sum rather than
matmuls, so no TF32 setting can reach them (the JAX code pins
Precision.HIGHEST for the same 1e-3 A gate), and a float32 chain is
composed in float64 (``chain_positions_grouped``). All functions broadcast
over leading dims.
"""
from __future__ import annotations

import functools

import torch

# Matches torch.nn.functional.normalize's zero-norm guard.
NORM_EPS = 1e-12


@functools.cache
def device_constant(values, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, made once per (values,
    device, dtype): made per call on a GPU it is a host-to-device copy that
    waits on the stream. Made outside inference mode, so that a later call
    may save it for a backward; callers never write into it."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def as_operand(x, like: torch.Tensor) -> torch.Tensor:
    """x as a tensor of ``like``'s dtype and device; a Python number comes
    from ``device_constant``, never from a copy per call."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=like.dtype, device=like.device)
    return device_constant(float(x), like.device, like.dtype)


def normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """v / max(|v|, eps), with the *squared* norm clamped at eps^2 so the
    zero-vector branch has a zero gradient rather than a NaN one."""
    n2 = torch.sum(v * v, dim=dim, keepdim=True)
    return v * torch.rsqrt(torch.clamp(n2, min=NORM_EPS * NORM_EPS))


def nerf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
         length, theta, chi) -> torch.Tensor:
    """Place the 4th atom from 3 frame atoms and internal coordinates.

    a, b, c: (..., 3); length, theta (bond angle), chi (torsion): (...,)
    tensors or scalars, radians."""
    w_hat = normalize(b - a)
    x_hat = normalize(c - b)
    z_hat = normalize(torch.linalg.cross(w_hat, x_hat, dim=-1))
    y_hat = torch.linalg.cross(z_hat, x_hat, dim=-1)
    length = as_operand(length, a)[..., None]
    theta = as_operand(theta, a)[..., None]
    chi = as_operand(chi, a)[..., None]
    d = (-length * torch.cos(theta) * x_hat
         + length * torch.sin(theta) * torch.cos(chi) * y_hat
         + length * torch.sin(theta) * torch.sin(chi) * z_hat)
    return c + d


def extension_transform(length: torch.Tensor, theta: torch.Tensor,
                        chi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Local rigid transform (R (..., 3, 3), t (..., 3)) of one extension.

    Columns of R are the new frame's axes in the old frame. The closed-form
    division by sin(theta) carries its sign: |e_x x u| = |sin(theta)|, and
    without the sign the y/z axes flip for theta < 0, which an untrained
    model predicts freely."""
    ct, st = torch.cos(theta), torch.sin(theta)
    cx, sx = torch.cos(chi), torch.sin(chi)
    zeros = torch.zeros_like(ct)
    sg = torch.where(st < 0, -1.0, 1.0).to(ct.dtype)
    r = torch.stack([
        torch.stack([-ct, -sg * st, zeros], dim=-1),
        torch.stack([st * cx, -sg * ct * cx, -sg * sx], dim=-1),
        torch.stack([st * sx, -sg * ct * sx, sg * cx], dim=-1),
    ], dim=-2)
    t = torch.stack([-length * ct, length * st * cx, length * st * sx], dim=-1)
    return r, t


def matmul3(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """m (..., 3, 3) @ x (..., 3, K) in exact fp32 (no TF32 path)."""
    return torch.sum(m[..., :, :, None] * x[..., None, :, :], dim=-2)


def matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m (..., 3, 3) @ v (..., 3) in exact fp32."""
    return torch.sum(m * v[..., None, :], dim=-1)


def compose_rigid(left, right):
    """(Ra, ta) o (Rb, tb) = (Ra @ Rb, ta + Ra @ tb); associative."""
    ra, ta = left
    rb, tb = right
    return matmul3(ra, rb), ta + matvec3(ra, tb)


def prefix_compose(r: torch.Tensor, t: torch.Tensor):
    """Inclusive prefix composition over dim -3 of r (..., K, 3, 3) and dim
    -2 of t (..., K, 3): out[i] = x[0] o x[1] o ... o x[i].

    A log2(K)-step doubling (Hillis-Steele) scan. It composes in another
    tree order than jax.lax.associative_scan, so results differ in the last
    fp32 bits (about 1e-5 A at L=256)."""
    k = r.shape[-3]
    shift = 1
    while shift < k:
        nr, nt = compose_rigid((r[..., :-shift, :, :], t[..., :-shift, :]),
                               (r[..., shift:, :, :], t[..., shift:, :]))
        r = torch.cat([r[..., :shift, :, :], nr], dim=-3)
        t = torch.cat([t[..., :shift, :], nt], dim=-2)
        shift *= 2
    return r, t


def chain_positions_grouped(r0: torch.Tensor, t0: torch.Tensor,
                            lengths: torch.Tensor, thetas: torch.Tensor,
                            chis: torch.Tensor) -> torch.Tensor:
    """Chain positions with per-residue pre-composition.

    r0 (..., 3, 3), t0 (..., 3): seed frame. lengths/thetas/chis (..., K, G):
    K residue steps of G chained extensions (G=3 for N/CA/C). Returns
    (..., K, G, 3) global positions of every extended atom.

    A float32 chain is composed in float64 and its positions rounded once.
    Composed in float32 on an H100, whose float32 cos and sin miss the
    rounded value by a unit in the last place for a share of arguments,
    the chains of tools/gen_scale_data.py (L <= 250) came out 2e-3 A from
    a float64 build, over the 1e-3 A gate; the sidechains carry the
    backbone's local error on."""
    if t0.dtype == torch.float32:
        return chain_positions_grouped(
            r0.double(), t0.double(), lengths.double(), thetas.double(),
            chis.double()).float()
    k, g = lengths.shape[-2:]
    r, t = extension_transform(lengths, thetas, chis)  # (..., K, G, 3, 3)
    if k == 0:
        return t0[..., None, None, :] + t
    # Prefix-compose the G extensions inside each residue step.
    cum = [(r[..., 0, :, :], t[..., 0, :])]
    for a in range(1, g):
        cum.append(compose_rigid(cum[-1], (r[..., a, :, :], t[..., a, :])))
    local_t = torch.stack([c[1] for c in cum], dim=-2)  # (..., K, G, 3)

    # P_prev[i] = P_0 o ... o P_{i-1}, identity for i = 0.
    pr, pt = prefix_compose(*cum[-1])
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(
        *pr.shape[:-3], 1, 3, 3)
    pr_prev = torch.cat([eye, pr[..., :-1, :, :]], dim=-3)
    pt_prev = torch.cat([torch.zeros_like(pt[..., :1, :]), pt[..., :-1, :]],
                        dim=-2)

    # Atom a of step i: P_prev_i o (E1..E(a+1)) applied to the origin, then
    # mapped through the seed frame.
    local = pt_prev[..., :, None, :] + matvec3(pr_prev[..., :, None, :, :],
                                               local_t)
    return t0[..., None, None, :] + matvec3(r0[..., None, None, :, :], local)


def frame_from_points(a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor) -> torch.Tensor:
    """Orthonormal frame (columns x, y, z) from 3 seed atoms, origin at c."""
    w_hat = normalize(b - a)
    x_hat = normalize(c - b)
    z_hat = normalize(torch.linalg.cross(w_hat, x_hat, dim=-1))
    y_hat = torch.linalg.cross(z_hat, x_hat, dim=-1)
    return torch.stack([x_hat, y_hat, z_hat], dim=-1)
