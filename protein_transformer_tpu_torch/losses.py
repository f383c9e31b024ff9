"""Losses in PyTorch: angle MSE, dRMSD family, superposition RMSD.

Port of protein_transformer_tpu/losses.py, batched over proteins instead of
vmapped. Masks are explicit, as in the JAX package: the angle mask is True
where a target angle exists; the atom mask (B, L, 14) is True where a true
coordinate exists. Masked reductions equal the reference's
compact-then-reduce semantics.

The dRMSD pair sweep goes through ``ops.drmsd``: the CUDA kernels for CUDA
tensors (impl "cuda"), the plain PyTorch versions otherwise ("torch"). It is
differentiable in the predicted coordinates (``ops.drmsd.DrmsdStats``).
The superposition RMSD, a metric without a gradient, goes through
``ops.kabsch`` likewise: one kernel launch on CUDA tensors, the tensor body
with its SVD otherwise.

Every batch loss is a quotient: a sum over the batch's valid entries (or
real proteins) over their count. A rank that holds only its rows of the
global batch passes the global count (``count=``, from ``batch_counts``
summed over the ranks): its quotient is then its share of the global one,
the shares add up to it, and their gradients add up to its gradient.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from protein_transformer_tpu_torch import tracing
from protein_transformer_tpu_torch.protein.constants import (
    NUM_PREDICTED_ANGLES, NUM_PREDICTED_COORDS, SC_ANGLES_START_POS)
from protein_transformer_tpu_torch.ops import kabsch
from protein_transformer_tpu_torch.ops.drmsd import DIST_CLAMP, drmsd_stats
from protein_transformer_tpu_torch.ops.nerf import matmul3
from protein_transformer_tpu_torch.protein.geometry import (
    build_coords_batch, inverse_trig_transform)


def _angle_split(pred: torch.Tensor) -> int:
    a = pred.shape[-1]
    if a == NUM_PREDICTED_ANGLES * 2:
        return SC_ANGLES_START_POS * 2
    if a == NUM_PREDICTED_ANGLES:
        return SC_ANGLES_START_POS
    raise ValueError(f"Unknown angle tensor shape {tuple(pred.shape)}")


def mse_over_angles(pred: torch.Tensor, true: torch.Tensor,
                    mask: torch.Tensor, bb_only: bool = False,
                    sc_only: bool = False,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked MSE between (B, L, 24) sin/cos or (B, L, 12) radian tensors,
    averaged over the selected elements (``count`` of them in the global
    batch, by default those of this one); bb_only / sc_only slice at the
    first sidechain angle."""
    split = _angle_split(pred)
    if bb_only:
        pred, true, mask = pred[..., :split], true[..., :split], mask[..., :split]
    elif sc_only:
        pred, true, mask = pred[..., split:], true[..., split:], mask[..., split:]
    sq = torch.where(mask, (pred - true) ** 2, 0.0)
    if count is None:
        count = torch.sum(mask)
    return torch.sum(sq) / torch.clamp(count, min=1)


def batch_counts(ang_mask: torch.Tensor,
                 protein_mask: torch.Tensor) -> torch.Tensor:
    """The denominators of the batch losses, as one int64 vector: the valid
    angle entries (all, backbone, sidechain) and the real proteins."""
    split = _angle_split(ang_mask)
    return torch.stack([torch.sum(ang_mask), torch.sum(ang_mask[..., :split]),
                        torch.sum(ang_mask[..., split:]),
                        torch.sum(protein_mask)])


def drmsd_masked(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                 impl: str = "auto") -> torch.Tensor:
    """Masked dRMSD = sqrt(mean over valid i<j pairs of (Da - Db)^2).

    a, b: (..., N, 3); mask: (..., N). Returns (...,). impl: "cuda" (the
    kernels; CUDA tensors only), "torch" (plain) or "auto" (by device).
    The clamp before sqrt keeps its slope finite for empty or identical
    sets, so padded dummy rows give zero gradients, not NaN."""
    s, c = drmsd_stats(a, b, mask, impl)
    c = torch.clamp(c, min=1).to(s.dtype)
    return torch.sqrt(torch.clamp(s / c, min=DIST_CLAMP))


class DrmsdResults(NamedTuple):
    """dRMSD statistics, batch means (scalars) or per protein (B,)."""
    drmsd: torch.Tensor
    ln_drmsd: torch.Tensor
    drmsd_bb: torch.Tensor
    ln_drmsd_bb: torch.Tensor


def per_protein_drmsd(pred_crd: torch.Tensor, true_crd: torch.Tensor,
                      atom_mask: torch.Tensor, impl: str = "auto",
                      backbone_only: bool = False) -> DrmsdResults:
    """Per-protein dRMSD statistics, each (B,), from (B, L, 14, 3) coords.

    The backbone statistic compacts to the 3L N/CA/C atoms before the pair
    sweep. backbone_only (the reference's --backbone_loss) reports the
    backbone values in the 'full' slots too and never sweeps all 14L atoms.
    ln-dRMSD is dRMSD over the number of valid atoms."""
    bsz = pred_crd.shape[0]
    a_bb = pred_crd[:, :, :3].reshape(bsz, -1, 3)
    b_bb = true_crd[:, :, :3].reshape(bsz, -1, 3)
    m_bb = atom_mask[:, :, :3].reshape(bsz, -1)
    bb = drmsd_masked(a_bb, b_bb, m_bb, impl)
    ln_bb = bb / torch.clamp(m_bb.sum(-1), min=1)
    if backbone_only:
        return DrmsdResults(bb, ln_bb, bb, ln_bb)
    n = pred_crd.shape[1] * NUM_PREDICTED_COORDS
    m = atom_mask.reshape(bsz, n)
    full = drmsd_masked(pred_crd.reshape(bsz, n, 3),
                        true_crd.reshape(bsz, n, 3), m, impl)
    ln = full / torch.clamp(m.sum(-1), min=1)
    return DrmsdResults(full, ln, bb, ln_bb)


def _masked_mean(v: torch.Tensor, protein_mask: Optional[torch.Tensor],
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the real proteins (``count`` of them in the global batch,
    by default those of this one)."""
    if protein_mask is None:
        return torch.mean(v)
    w = protein_mask.to(v.dtype)
    count = torch.sum(w) if count is None else count.to(v.dtype)
    return torch.sum(v * w) / torch.clamp(count, min=1.0)


def compute_batch_drmsd(pred_sincos: torch.Tensor, true_crd: torch.Tensor,
                        seq: torch.Tensor, atom_mask: torch.Tensor,
                        protein_mask: Optional[torch.Tensor] = None,
                        impl: str = "auto",
                        pred_crd: Optional[torch.Tensor] = None,
                        with_per_protein: bool = False,
                        backbone_only: bool = False,
                        n_proteins: Optional[torch.Tensor] = None):
    """Batch-mean dRMSD family from (B, L, 24) predictions.

    protein_mask: optional (B,) bool marking real rows; padded dummy rows
    are left out of the mean, over ``n_proteins`` real ones (by default
    this batch's). pred_crd skips the NeRF build when the caller already
    has the coordinates. with_per_protein also returns the (B,) statistics,
    as (means, per-protein), for the reference gradient semantics."""
    if pred_crd is None:
        pred_crd = build_coords_batch(inverse_trig_transform(pred_sincos), seq)
    per = per_protein_drmsd(pred_crd, true_crd, atom_mask, impl,
                            backbone_only)
    res = DrmsdResults(*(_masked_mean(v, protein_mask, n_proteins)
                         for v in per))
    return (res, per) if with_per_protein else res


def combine_drmsd_mse(d, mse, w: float = 0.5, lndrmsd_norm: float = 0.02,
                      mse_norm: float = 0.01):
    """z-scaled combination of ln-dRMSD and angle MSE."""
    return w * (d / lndrmsd_norm) + (1 - w) * (mse / mse_norm)


def kabsch_rmsd_masked(a: torch.Tensor, b: torch.Tensor,
                       w: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Superposition RMSD of masked point sets, batched.

    a, b: (..., N, 3); w: (..., N) 0/1 weights. Aligns a onto b over the
    selected points (weighted Kabsch with a 3x3 SVD) and returns their RMSD
    (...,). SVD sign conventions differ between libraries; the determinant
    correction makes the RMSD independent of them. An all-zero w gives 0.

    impl "cuda" runs the kernel (``ops.kabsch``: float32 CUDA tensors, a
    bool w, no gradient; one launch and no wait for the device), "torch"
    the tensor body below, "auto" picks by a's device."""
    if kabsch.resolve_impl(impl, a.device) == "cuda":
        lead, n = a.shape[:-2], a.shape[-2]
        return kabsch.kabsch_rmsd_cuda(
            a.reshape(-1, n, 3).contiguous(), b.reshape(-1, n, 3).contiguous(),
            w.reshape(-1, n).contiguous()).reshape(lead)
    w = w.to(a.dtype)[..., None]
    total = torch.clamp(torch.sum(w, dim=-2), min=1.0)       # (..., 1)
    am = torch.sum(a * w, dim=-2) / total
    bm = torch.sum(b * w, dim=-2) / total
    ac = (a - am[..., None, :]) * w
    bc = (b - bm[..., None, :]) * w
    h = torch.sum(ac[..., :, :, None] * bc[..., :, None, :], dim=-3)
    # on a GPU the call waits for the device
    with tracing.wait("kabsch_svd"):
        u, _s, vt = torch.linalg.svd(h)
    d = torch.sign(torch.linalg.det(matmul3(u, vt)))
    flip = torch.ones_like(u[..., 0, :])
    flip = torch.cat([flip[..., :2], d[..., None]], dim=-1)
    rot = matmul3(u * flip[..., None, :], vt)
    aligned = torch.sum((a - am[..., None, :])[..., :, :, None]
                        * rot[..., None, :, :], dim=-2)
    diff = (aligned - (b - bm[..., None, :])) * w
    return torch.sqrt(torch.sum(diff ** 2, dim=(-2, -1)) / total[..., 0])


def batch_rmsd(pred_crd: torch.Tensor, true_crd: torch.Tensor,
               atom_mask: torch.Tensor,
               protein_mask: Optional[torch.Tensor] = None,
               n_proteins: Optional[torch.Tensor] = None,
               impl: str = "auto") -> torch.Tensor:
    """Mean per-protein masked superposition RMSD over a batch (over
    ``n_proteins`` real ones, by default this batch's), on the tensors'
    device (the JAX package's ``batch_rmsd_jax``); ``impl`` as
    ``kabsch_rmsd_masked`` takes it."""
    bsz = pred_crd.shape[0]
    vals = kabsch_rmsd_masked(pred_crd.reshape(bsz, -1, 3),
                              true_crd.reshape(bsz, -1, 3),
                              atom_mask.reshape(bsz, -1), impl)
    return _masked_mean(vals, protein_mask, n_proteins)
